"""Side-by-side engine comparison harness.

Reference analog: scripts/start-benchmark-comparison.sh races IResearch
against Lucene over a doc-count ladder and format-benchmark-results.sh
collates per-category execution times. The reference C++ binary cannot be
built in-image (BASELINE.md), so this harness races the two engines this
package ships — the device executor and the numpy host oracle — on an
identical corpus and task mix, verifying recall@K == 1.0 between them and
emitting the same per-category CSV shape.

Usage:
  python scripts/compare_engines.py [--docs 50000] [--ladder 10000,50000]
      [--topn 10] [--tasks-per-category 10] [--csv out.csv]
      [--gateway host:port]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_index(num_docs: int, vocab: int = 30_000):
    from iresearch_tpu.formats.postings import encode_field_postings
    from iresearch_tpu.formats.spec import IndexFeatures
    from iresearch_tpu.index.invert import invert_numpy
    from iresearch_tpu.index.segment import SegmentData, SegmentReader

    rng = np.random.default_rng(42)
    lens = rng.integers(32, 96, size=num_docs)
    total = int(lens.sum())
    tids = np.minimum(rng.zipf(1.25, size=total) - 1, vocab - 1).astype(np.int64)
    doc_of_tok = np.repeat(np.arange(num_docs), lens)
    starts = np.cumsum(lens) - lens
    pos_of_tok = (
        np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
    ).astype(np.uint32)
    inv = invert_numpy(tids, doc_of_tok, pos_of_tok, vocab, num_docs)
    present = np.flatnonzero(np.diff(inv.term_ptr) > 0)
    terms = [b"t%06d" % t for t in present]
    blob = b"".join(terms)
    offs = np.zeros(len(terms) + 1, np.uint64)
    offs[1:] = np.cumsum([len(t) for t in terms])
    tp = np.concatenate([inv.term_ptr[present], [inv.term_ptr[-1]]])
    fp = encode_field_postings(
        inv.e_doc, inv.e_freq, tp, blob, offs, inv.norms, inv.pos_flat,
        IndexFeatures.FREQ | IndexFeatures.POS,
    )
    sr = SegmentReader("cmp", SegmentData(num_docs, {"body": fp}, {}))
    return sr, terms, fp


def make_tasks(terms, fp, per_cat: int):
    """(category, filter) pairs over the standard luceneutil categories."""
    from iresearch_tpu.search import filters as F

    dfs = fp.entries[:, 0].astype(np.int64)
    order = np.argsort(-dfs)

    def t(rank):
        return terms[order[min(rank, len(order) - 1)]].decode()

    tasks = []
    for i in range(per_cat):
        hi, me, lo = t(2 + i), t(200 + i), t(2000 + i)
        tasks.append(("HighTerm", F.ByTerm("body", hi)))
        tasks.append(("MedTerm", F.ByTerm("body", me)))
        tasks.append(("LowTerm", F.ByTerm("body", lo)))
        tasks.append(("AndHighMed", F.And(F.ByTerm("body", hi), F.ByTerm("body", me))))
        tasks.append(("AndHighLow", F.And(F.ByTerm("body", hi), F.ByTerm("body", lo))))
        tasks.append(("OrHighMed", F.Or(F.ByTerm("body", hi), F.ByTerm("body", me))))
        tasks.append((
            "Or4High",
            F.Or(*[F.ByTerm("body", t(2 + i + j)) for j in range(4)]),
        ))
        tasks.append((
            "MinMatch2High2Med",
            F.Or(
                F.ByTerm("body", t(2 + i)), F.ByTerm("body", t(3 + i)),
                F.ByTerm("body", t(200 + i)), F.ByTerm("body", t(201 + i)),
                min_match=2,
            ),
        ))
        tasks.append(("MedPhrase", F.ByPhrase("body", [t(30 + i), t(31 + i)])))
        tasks.append(("Prefix3", F.ByPrefix("body", t(40 + i)[:3])))
        tasks.append(("Fuzzy1", F.ByEditDistance("body", t(50 + i), max_distance=1)))
    return tasks


def run_compare(num_docs: int, topn: int, per_cat: int):
    from collections import defaultdict

    from iresearch_tpu.exec import DeviceQuery
    from iresearch_tpu.search.host_eval import HostQuery
    from iresearch_tpu.search.scorers import BM25

    sr, terms, fp = build_index(num_docs)
    tasks = make_tasks(terms, fp, per_cat)
    scorer = BM25()
    log(f"docs={num_docs}: {len(tasks)} tasks over {len(set(c for c, _ in tasks))} categories")

    dev_t = defaultdict(float)
    host_t = defaultdict(float)
    calls = defaultdict(int)
    mismatches = 0
    for cat, flt in tasks:
        dq = DeviceQuery(flt, [sr], scorer, wand=True)
        dq.execute_segment(0, topn)  # compile + upload outside the timing
        t0 = time.time()
        vals, docs = dq.execute_segment(0, topn)
        dev_t[cat] += time.time() - t0

        t0 = time.time()
        hq = HostQuery(flt, [sr], scorer)
        want = hq.top_k(topn)
        host_t[cat] += time.time() - t0

        got = [
            (int(d), float(v)) for v, d in zip(vals, docs) if np.isfinite(v)
        ]
        if [d for d, _ in got] != [d for d, _ in want]:
            mismatches += 1
            log(f"RANKING MISMATCH [{cat}]: {got[:3]} vs {want[:3]}")
        calls[cat] += 1
    rows = []
    for cat in sorted(calls):
        d_us = dev_t[cat] * 1e6 / calls[cat]
        h_us = host_t[cat] * 1e6 / calls[cat]
        rows.append((num_docs, cat, calls[cat], d_us, h_us, h_us / max(d_us, 1e-9)))
    return rows, mismatches


def main(argv=None) -> int:
    from iresearch_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--docs", type=int, default=50_000)
    p.add_argument("--ladder", default=None,
                   help="comma-separated doc counts (overrides --docs)")
    p.add_argument("--topn", type=int, default=10)
    p.add_argument("--tasks-per-category", type=int, default=5)
    p.add_argument("--csv", default=None)
    p.add_argument("--gateway", default=None,
                   help="Prometheus PushGateway host:port")
    args = p.parse_args(argv)

    sizes = (
        [int(s) for s in args.ladder.split(",")] if args.ladder else [args.docs]
    )
    all_rows = []
    total_mismatches = 0
    for n in sizes:
        rows, mism = run_compare(n, args.topn, args.tasks_per_category)
        all_rows.extend(rows)
        total_mismatches += mism

    header = "docs,category,calls,device_us,host_us,speedup"
    lines = [header] + [
        f"{n},{cat},{c},{d:.0f},{h:.0f},{s:.1f}x"
        for n, cat, c, d, h, s in all_rows
    ]
    out = "\n".join(lines)
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write(out + "\n")
    print(out)
    print(f"recall@{args.topn} parity: "
          + ("OK (identical rankings)" if total_mismatches == 0
             else f"{total_mismatches} MISMATCHES"))
    if args.gateway:
        from iresearch_tpu.utils.metrics import MetricsRegistry

        m = MetricsRegistry()
        for n, cat, c, d, h, s in all_rows:
            labels = {"category": cat, "docs": str(n)}
            m.gauge("Time", d, {**labels, "engine": "device"},
                    help_="query execution time (us)")
            m.gauge("Time", h, {**labels, "engine": "host"})
        ok = m.push(args.gateway)
        log(f"push to {args.gateway}: {'ok' if ok else 'FAILED (kept local)'}")
    return 1 if total_mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
