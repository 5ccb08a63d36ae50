"""Profile the serving-shaped path at the canonical 5M corpus.

Splits a fresh-query batch's cost into: filter build / DeviceQuery
construction (HostQuery prepare) / plan_for_k / prepare() stacking+pack /
dispatch enqueue / completion — the breakdown VERDICT r4 item 1 asks for.
Requires the bench cache (run `python bench.py` once first).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from iresearch_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from iresearch_tpu.formats.segment_io import read_segment
    from iresearch_tpu.index.segment import SegmentReader
    from iresearch_tpu.search import filters as F
    from iresearch_tpu.search.scorers import BM25
    from iresearch_tpu.exec.batch import QueryBatch

    n = int(os.environ.get("BENCH_DOCS", 5_000_000))
    cache = os.path.join(
        os.path.dirname(__file__), "..", ".bench_cache",
        f"seg_{n}_30000_v5.bin",
    )
    t0 = time.time()
    with open(cache, "rb") as f:
        data = read_segment(f.read())
    sr = SegmentReader("bench0", data)
    srs = [sr]
    print(f"segment loaded ({time.time()-t0:.1f}s)", flush=True)
    fp = data.fields["body"]
    tv = sr.terms("body")
    terms = [tv[i] for i in range(len(tv))]
    dfs = fp.entries[:, 0].astype(np.int64)
    order = np.argsort(-dfs)

    def term_at(rank):
        return terms[order[min(rank, len(order) - 1)]].decode()

    scorer = BM25()
    K = 10

    def sync(arr):
        return float(np.asarray(arr.reshape(-1)[0]))

    import jax.numpy as jnp

    tiny = jnp.zeros(8, jnp.float32) + 1.0
    sync(tiny)
    rtts = []
    for _ in range(5):
        t2 = time.time()
        sync(tiny * 1.0)
        rtts.append(time.time() - t2)
    rtt = sorted(rtts)[2]
    print(f"rtt {rtt*1000:.1f} ms")

    def build_filters(rot):
        fresh = []
        for j in range(25):
            a = term_at(2 + (rot + j) % 600)
            b = term_at(200 + (rot + j) % 1200)
            fresh.append(F.ByTerm("body", a))
            fresh.append(F.And(F.ByTerm("body", a), F.ByTerm("body", b)))
        return fresh

    rots = [0, 37, 74, 111]
    # warm
    for r in rots:
        qb = QueryBatch(build_filters(r), srs, scorer, wand=True)
        sync(qb.prepare(0, K).run_grouped()[-1][0][0])
    print("warm done", flush=True)

    # stage timings over many rounds
    t_build = t_qb = t_prep = t_disp = 0.0
    NB = 40
    nq = 0
    last = None
    t_all0 = time.time()
    for i in range(NB):
        r = rots[i % 4]
        t1 = time.time()
        fresh = build_filters(r)
        t2 = time.time()
        qb = QueryBatch(fresh, srs, scorer, wand=True)
        t3 = time.time()
        prep = qb.prepare(0, K)
        t4 = time.time()
        res = prep.run_grouped()
        last = res[-1][0][0]
        t5 = time.time()
        t_build += t2 - t1
        t_qb += t3 - t2
        t_prep += t4 - t3
        t_disp += t5 - t4
        nq += len(fresh)
    sync(last)
    wall = time.time() - t_all0
    print(
        f"{nq} fresh queries, wall {wall:.3f}s -> {nq/wall:.0f} QPS "
        f"(one final sync)"
    )
    print(
        f"per-batch(50q) host ms: filters {t_build/NB*1e3:.2f} "
        f"qb-init {t_qb/NB*1e3:.2f} prepare {t_prep/NB*1e3:.2f} "
        f"dispatch {t_disp/NB*1e3:.2f}"
    )
    print(
        f"per-query us: filters {t_build/nq*1e6:.0f} qb {t_qb/nq*1e6:.0f} "
        f"prepare {t_prep/nq*1e6:.0f} dispatch {t_disp/nq*1e6:.0f} "
        f"total-host {(t_build+t_qb+t_prep+t_disp)/nq*1e6:.0f}"
    )

    # program-count proxy: distinct fused cache keys used by the mix
    from iresearch_tpu.exec import batch as B

    print(f"fused-cache programs: {len(B._FUSED_CACHE)}")

    if os.environ.get("PROF"):
        import cProfile, pstats

        pr = cProfile.Profile()
        pr.enable()
        for i in range(20):
            r = rots[i % 4]
            qb = QueryBatch(build_filters(r), srs, scorer, wand=True)
            qb.prepare(0, K).run_grouped()
        pr.disable()
        pstats.Stats(pr).sort_stats("cumulative").print_stats(35)


if __name__ == "__main__":
    main()
