"""Multiterm host-prepare cost at 25M docs (5 segments).

VERDICT r4 item 2: @25M, Fuzzy1 24.2 ms / Prefix 11.3 ms amortized =
5 independent dict intersects + 5 plan setups. The merged cross-segment
dictionary (index/multidict.py, cached by segment serials) runs ONE
byte-DFA intersect per query; this measures the resulting amortized
host prepare cost per fresh query. Target: <= 3 ms.

Usage: python scripts/bench_prepare25m.py   (needs the .bench_cache
segments a BENCH_DOCS=25000000 bench run leaves behind)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")


def main():
    from iresearch_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from iresearch_tpu.formats.segment_io import read_segment
    from iresearch_tpu.index.segment import SegmentReader
    from iresearch_tpu.search import filters as F

    # use every cached 5M segment present (a 25M bench run leaves 5; a
    # merge-bench run leaves 2) — per-segment plan-setup cost is linear
    # in segment count, so fewer segments understate only that term
    srs = []
    t0 = time.time()
    for si in range(5):
        suffix = "" if si == 0 else f"_s{42 + si}"
        path = os.path.join(CACHE, f"seg_5000000_30000_v5{suffix}.bin")
        if not os.path.exists(path):
            break
        with open(path, "rb") as f:
            srs.append(SegmentReader(f"b{si}", read_segment(f.read())))
    if len(srs) < 2:
        sys.exit("need >= 2 cached 5M segments (run bench_merge.py first)")
    print(f"{len(srs)} segments loaded ({time.time()-t0:.1f}s)")

    def time_prepare(mk, n=30, label=""):
        from iresearch_tpu.exec import DeviceQuery

        # warm: builds + caches the merged dictionary (segment-serial
        # keyed), the per-segment dense-grid caches (one-time ~47 s each
        # on a degraded host — excluded like the bench's warmup phase),
        # and the plan-cache signature programs
        dq0 = DeviceQuery(mk(0), srs)
        for s in range(len(srs)):
            dq0.plan(s)
        t = time.time()
        for i in range(1, n + 1):
            dq = DeviceQuery(mk(i), srs)
            for s in range(len(srs)):
                dq.plan(s)
        dt = (time.time() - t) / n * 1000
        print(f"{label}: {dt:.2f} ms/query host prepare+plan (amortized, "
              f"{n} fresh queries x {len(srs)} segments)")
        return dt

    rng = np.random.default_rng(7)
    terms = [f"t{int(x):06d}" for x in rng.integers(0, 29000, 200)]

    f_dt = time_prepare(
        lambda i: F.ByEditDistance("body", terms[i], max_distance=1,
                                   scored_terms_limit=16),
        label="Fuzzy1",
    )
    p_dt = time_prepare(
        lambda i: F.ByPrefix("body", terms[i][:4], scored_terms_limit=16),
        label="Prefix",
    )
    ok = f_dt <= 3.0 and p_dt <= 3.0
    print(f"target <= 3 ms: {'MET' if ok else 'MISSED'}")


if __name__ == "__main__":
    main()
