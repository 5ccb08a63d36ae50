"""Consolidation-merge benchmark at production scale.

Times ``merge_segments`` over two 5M-doc bench segments (the canonical
post-consolidation shape) on the native streaming path vs the numpy
decode→lexsort→re-encode path, asserting byte-identical outputs.

Reference: /root/reference/core/index/merge_writer.cpp — the reference
treats segment merging as a HOT path (SURVEY §3.6); this records the
wall-clock evidence for the engine's native one-pass merge
(iresearch_native.cpp:irs_merge_decode).

Usage:  python scripts/bench_merge.py [ndocs_per_segment]
Reuses bench.py's .bench_cache segments when present (seg 0 = the 5M
bench segment, seg 1 = the 10M run's second segment); builds and caches
them otherwise (one-time, ~minutes at 5M on one CPU).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")
VOCAB = 30_000


def load_or_build(si: int, n: int):
    from iresearch_tpu.formats.segment_io import read_segment, write_segment
    from iresearch_tpu.formats.postings import encode_field_postings
    from iresearch_tpu.formats.spec import IndexFeatures
    from iresearch_tpu.index.invert import invert_numpy
    from iresearch_tpu.index.segment import SegmentData

    suffix = "" if si == 0 else f"_s{42 + si}"
    path = os.path.join(CACHE, f"seg_{n}_{VOCAB}_v5{suffix}.bin")
    if os.path.exists(path):
        t0 = time.time()
        with open(path, "rb") as f:
            data = read_segment(f.read())
        print(f"segment {si}: loaded from cache ({time.time()-t0:.1f}s)")
        return data
    # same corpus construction as bench.py (inverse-CDF clipped zipf)
    import bench as _bench

    t0 = time.time()
    lens, tids = _bench.build_corpus(n, seed=42 + si)
    doc_of_tok = np.repeat(np.arange(n), lens)
    starts = np.cumsum(lens) - lens
    pos_of_tok = (
        np.arange(len(tids), dtype=np.int64) - np.repeat(starts, lens)
    ).astype(np.uint32)
    inv = invert_numpy(tids, doc_of_tok, pos_of_tok, VOCAB, n)
    present = np.flatnonzero(np.diff(inv.term_ptr) > 0)
    terms_l = [b"t%06d" % t for t in present]
    blob = b"".join(terms_l)
    offs = np.zeros(len(terms_l) + 1, np.uint64)
    offs[1:] = np.cumsum([len(t) for t in terms_l])
    tp = np.concatenate([inv.term_ptr[present], [inv.term_ptr[-1]]])
    fpn = encode_field_postings(
        inv.e_doc, inv.e_freq, tp, blob, offs, inv.norms, inv.pos_flat,
        IndexFeatures.FREQ | IndexFeatures.POS,
    )
    data = SegmentData(n, {"body": fpn}, {})
    os.makedirs(CACHE, exist_ok=True)
    with open(path, "wb") as f:
        f.write(write_segment(data))
    print(f"segment {si}: built + cached ({time.time()-t0:.1f}s)")
    return data


def main():
    from iresearch_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 5_000_000
    from iresearch_tpu.index.merge import merge_segments
    from iresearch_tpu.index.segment import SegmentReader

    datas = [load_or_build(si, n) for si in range(2)]
    srs = [SegmentReader(f"m{si}", d) for si, d in enumerate(datas)]
    ntok = sum(d.fields["body"].total_term_freq for d in datas)
    print(f"2 x {n} docs, {ntok/1e6:.0f}M tokens total")

    results = {}
    for label, env in (("native", "1"), ("numpy", "0")):
        os.environ["IRS_MERGE_NATIVE"] = env
        t0 = time.time()
        merged = merge_segments(srs)
        dt = time.time() - t0
        results[label] = (dt, merged)
        print(
            f"{label:7s} merge: {dt:8.2f}s "
            f"({ntok/dt/1e6:.2f}M tokens/s, {2*n/dt:,.0f} docs/s)"
        )

    # byte-identical gate (same as tests/test_merge_native.py, at scale)
    from iresearch_tpu.formats.segment_io import write_segment

    t0 = time.time()
    b_nat = write_segment(results["native"][1])
    b_np = write_segment(results["numpy"][1])
    assert b_nat == b_np, "native merge output differs from numpy path"
    print(f"outputs byte-identical ({len(b_nat)/1e6:.1f} MB, checked in {time.time()-t0:.1f}s)")
    speedup = results["numpy"][0] / results["native"][0]
    print(f"speedup: {speedup:.2f}x (target >= 3x)")


if __name__ == "__main__":
    main()
