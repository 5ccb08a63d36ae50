"""End-to-end A/B of ``wide_top_k``'s routing, with cold compiles.

    python scripts/topk_ab.py [--docs N] [--seed S] [--per-category Q]
                              [--order routed,tournament,routed]

Builds the index of ``chip_smoke.py`` (IndexWriter, two segments), then
runs each variant of ``--order`` in turn:

- ``routed``: rows narrower than ``ops/topk._MIN_WIDTH`` take
  ``lax.top_k``, wider rows the tournament (the shipped rule);
- ``tournament``: ``_MIN_WIDTH = 0``, so every row wider than the
  tournament's chunk takes it.

Before each variant it clears JAX's in-process caches; the persistent
compile cache is off for the whole run, so every variant compiles cold.
Each variant prints the mixed batch's first run at k=100 (compile
included), its steady ms per pass, and per-category ms/query at k=10
with the compile-and-first-run seconds, as median (min-max) of five
readings. Every variant's results are compared with the first's.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

VARIANTS = ("routed", "tournament")


def run_variant(name, min_width, reader, cats, card):
    import jax

    from iresearch_tpu.ops import topk

    shipped, topk._MIN_WIDTH = topk._MIN_WIDTH, min_width
    try:
        return _measure(name, reader, cats, card)
    finally:
        # programs traced under the variant's rule go with it
        topk._MIN_WIDTH = shipped
        jax.clear_caches()


def _measure(name, reader, cats, card):
    import jax

    from iresearch_tpu.exec.batch import QueryBatch
    from iresearch_tpu.search.scorers import BM25

    jax.clear_caches()
    segs = list(reader.segments)
    queries = [q for qs in cats.values() for q in qs]
    mb = QueryBatch(queries, segs, BM25(), wand=True).prepare_all(100)
    t0 = time.perf_counter()
    vals, docs = jax.block_until_ready(mb.run())
    first = time.perf_counter() - t0
    ms = cs._readings(mb.run)
    cs.say(f"[{name}] mix k=100: first run incl. compile {first:.3f} s; "
           f"{cs._spread(ms)} ms per pass of {len(queries)} queries on {card}")
    hits = [cs.hits_of(v, d) for v, d in zip(np.asarray(vals), np.asarray(docs))]
    for cat, qs in cats.items():
        cb = QueryBatch(qs, segs, BM25(), wand=True).prepare_all(10)
        t0 = time.perf_counter()
        jax.block_until_ready(cb.run())
        warm = time.perf_counter() - t0
        ms = [t / len(qs) for t in cs._readings(cb.run)]
        cs.say(f"[{name}] {cat}: {cs._spread(ms)} ms/query (batch of "
               f"{len(qs)}, k=10; compile + first run {warm:.3f} s)")
    return hits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--per-category", type=int, default=4)
    ap.add_argument("--order", default="routed,tournament,routed")
    args = ap.parse_args(argv)
    order = args.order.split(",")
    for name in order:
        cs.check(name in VARIANTS, f"unknown variant {name!r}")

    import jax

    from iresearch_tpu.ops import topk

    widths = {"routed": topk._MIN_WIDTH, "tournament": 0}
    jax.config.update("jax_enable_compilation_cache", False)
    d = jax.devices()[0]
    card = cs.card_line() if d.platform == "gpu" else d.device_kind
    cs.say(f"[device] {d.platform} {d.device_kind}, jax {jax.__version__}; "
           f"card: {card}")
    cs.phase_native()
    reader = cs.phase_ingest(args.docs, args.seed, 2)
    cats = cs.category_queries(reader, args.per_category)
    names = [c for c, qs in cats.items() for _ in qs]
    base = None
    problems = []
    for name in order:
        hits = run_variant(name, widths[name], reader, cats, card)
        if base is None:
            base = hits
            continue
        for qi, (got, want) in enumerate(zip(hits, base)):
            for p in cs.compare_topk(got, want, 100):
                problems.append(f"{name} vs {order[0]} {names[qi]} #{qi}: {p}")
    cs.check(not problems, "\n  ".join(problems[:40]))
    cs.say(f"[ab] every variant's k=100 results agree with {order[0]}'s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
