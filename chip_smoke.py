#!/usr/bin/env python3
"""Index-and-search smoke test on one NVIDIA GPU, checked against the oracle.

    python chip_smoke.py [--docs N] [--seed S] [--per-category Q]
    python chip_smoke.py --four-cards [--docs N] [--seed S]

One process drives the main path through the entry points a user calls:
``IndexWriter`` -> ``DirectoryReader`` -> ``QueryBatch(...).prepare_all(k)
.run()`` and ``search_device``, on a 1,000,000-document index by default,
and compares every result with ``search/host_eval.py``. Phases:

1. device   — refuse anything but a GPU; name the card and its power limit.
2. native   — build ``native/`` with make and load it (no Python fallback).
3. ingest   — Zipf(1.25) text over a 30k-term vocabulary, 32-95 tokens a
              document (``bench.build_corpus``), segmentation analyzer,
              committed in two halves so the reader has two segments.
4. queries  — the luceneutil category mix, batched and single, k=10 and
              k=100; the execution tier of every query; per-category
              ms/query; peak device memory.
5. kernels  — the top-k decision at the real grid and batch shapes:
              the tournament against ``lax.top_k``.

``--four-cards`` runs one phase instead: the same corpus in four segments,
sharded over four GPUs with ``ShardedSearcher``, compared at k=10 with the
oracle and with the one-card ``QueryBatch`` result.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
any failed check exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Scores must agree with the oracle to rtol 1e-5, the repo's exactness
# invariant. On the GPU the scatter-adds of the dense fold and of the
# candidate tiers (exec/executor.py, exec/candidates.py) run as atomics,
# which add floats in an order that can change from run to run; so two
# docs whose oracle scores lie within that tolerance may trade places,
# and a doc tied with the k-th may stand in for it. No matrix product is
# on this path, so TF32 does not apply.
RTOL = 1e-5
ATOL = 1e-6

# the tiers the planner can choose (exec/plan.py exec_mode, plus the fused
# row-max scan, the skyline and WAND); every one must run on the card
TIERS = ("dense", "sort", "join", "dslice", "gridmix", "scan", "skyline", "wand")


def say(*parts) -> None:
    print(*parts, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --- result comparison -------------------------------------------------


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= RTOL * abs(b) + ATOL


def compare_topk(got, want, k: int):
    """Problems (empty when equal) between two ordered top-k lists of
    (doc, score): ``want`` is the oracle's. Matched doc sets must be
    equal and scores agree to RTOL; docs may differ in order, or at the
    k-th place, only where their oracle scores are within RTOL."""
    problems = []
    if len(got) != len(want):
        return [f"{len(got)} hits, oracle has {len(want)}"]
    want_score = dict(want)
    for i, ((gd, gs), (wd, ws)) in enumerate(zip(got, want)):
        if not _close(gs, ws):
            problems.append(f"rank {i}: score {gs!r}, oracle {ws!r}")
        if gd == wd:
            continue
        if gd in want_score:
            if not _close(want_score[gd], ws):
                problems.append(
                    f"rank {i}: doc {gd} (oracle score {want_score[gd]!r}) "
                    f"in place of doc {wd} ({ws!r})"
                )
        elif len(want) < k or not _close(gs, want[-1][1]):
            # a doc outside the oracle's list may only stand in for a
            # doc tied with the k-th
            problems.append(f"rank {i}: doc {gd} is not in the oracle's top-{k}")
    missing = set(want_score) - {d for d, _ in got}
    for d in sorted(missing):
        # only a doc tied with the device's k-th may drop out
        if len(want) < k or not _close(got[-1][1], want_score[d]):
            problems.append(f"oracle doc {d} ({want_score[d]!r}) missing")
    return problems


def hits_of(vals, docs):
    """Ordered [(doc, score)] of one device top-k row, -inf = no hit."""
    return [
        (int(d), float(v))
        for v, d in zip(np.asarray(vals), np.asarray(docs))
        if np.isfinite(v)
    ]


# --- tiers -------------------------------------------------------------


def batch_tiers(merged):
    """{query index: set of tiers} of a prepared ``MergedBatch``, read
    from the dispatches it actually holds (one PreparedBatch a segment)."""
    from iresearch_tpu.exec import batch as B

    out = {}
    for si, prep in enumerate(merged.preps):
        for qis, _args, kwargs, fn in prep._calls:
            if fn is B._run_batch_skyline:
                t = {"dense", "skyline"}
            elif fn is B._run_batch_dslice:
                t = {"dslice"}
            elif fn is B._run_batch_candidates:
                t = {kwargs["mode"]} | ({"wand"} if kwargs["wand"] else set())
            elif fn is B._run_batch_wand:
                t = {"dense", "wand"}
            elif kwargs.get("use_scan"):
                t = {"dense", "scan"}
            else:
                t = {"dense"}
            for qi in qis:
                out.setdefault(qi, set()).update(t)
    return out


def missing_tiers(tiers_by_query) -> list:
    seen = set().union(*tiers_by_query.values()) if tiers_by_query else set()
    return [t for t in TIERS if t not in seen]


# --- corpus and queries ------------------------------------------------


def corpus_texts(num_docs: int, seed: int):
    """Documents of the benchmark corpus (bench.build_corpus) as text."""
    from bench import VOCAB, build_corpus

    lens, tids = build_corpus(num_docs, seed=seed)
    vocab = [f"t{i:06d}" for i in range(VOCAB)]
    ends = np.cumsum(lens)
    tl = tids.tolist()
    out = []
    start = 0
    for end in ends.tolist():
        out.append(" ".join([vocab[t] for t in tl[start:end]]))
        start = end
    return out


def build_index(texts, segments: int):
    """IndexWriter ingest with ``segments`` commits of equal size ->
    (DirectoryReader, host seconds)."""
    from iresearch_tpu.index.reader import DirectoryReader
    from iresearch_tpu.index.writer import Field, IndexWriter
    from iresearch_tpu.store.directory import MemoryDirectory

    d = MemoryDirectory()
    n = len(texts)
    cuts = [n * (i + 1) // segments for i in range(segments)]
    t0 = time.perf_counter()
    with IndexWriter(d) as w:
        lo = 0
        for hi in cuts:
            for a in range(lo, hi, 1000):
                with w.batch() as tx:
                    for text in texts[a : min(a + 1000, hi)]:
                        tx.insert([Field("body", text, analyzer="segmentation")])
            w.commit()
            lo = hi
    secs = time.perf_counter() - t0
    return DirectoryReader.open(d), secs


def category_queries(reader, per_category: int):
    """{category: [filter]} — the luceneutil mix of bench.py, with terms
    picked by document frequency in the first segment. OrMed4 (four
    terms of df rank 600+) is added so that a disjunction of postings
    lists runs the sort tier with WAND: at 1M docs the high terms of
    OrHigh4 live on the dense grid and take the fused scan."""
    from iresearch_tpu.search import filters as F

    sr = reader.segments[0]
    fp = sr.field("body")
    tv = sr.terms("body")
    order = np.argsort(-fp.entries[:, 0].astype(np.int64), kind="stable")

    def term_at(rank):
        return tv[int(order[min(rank, len(order) - 1)])].decode()

    n = per_category
    high = [term_at(2 + i) for i in range(4 * n)]
    med = [term_at(200 + i) for i in range(2 * n)]
    # below the dense-grid cut at 1M docs, long enough for block-max WAND
    med4 = [term_at(600 + i) for i in range(4 * n)]
    low = [term_at(2000 + i) for i in range(n)]
    T = lambda t: F.ByTerm("body", t)  # noqa: E731
    return {
        "HighTerm": [T(t) for t in high[:n]],
        "MedTerm": [T(t) for t in med[:n]],
        "LowTerm": [T(t) for t in low],
        "AndHighHigh": [F.And(T(high[i]), T(high[i + 2])) for i in range(n)],
        "AndHighMed": [F.And(T(high[i]), T(med[i])) for i in range(n)],
        "AndHighLow": [F.And(T(high[i]), T(low[i])) for i in range(n)],
        "OrHighMed": [F.Or(T(high[i]), T(med[i])) for i in range(n)],
        "OrHigh4": [
            F.Or(*[T(t) for t in high[4 * i : 4 * i + 4]]) for i in range(n)
        ],
        "OrMed4": [
            F.Or(*[T(t) for t in med4[4 * i : 4 * i + 4]]) for i in range(n)
        ],
        "MinMatch2High2Med": [
            F.Or(
                T(high[2 * i]), T(high[2 * i + 1]),
                T(med[2 * i]), T(med[2 * i + 1]),
                min_match=2,
            )
            for i in range(n)
        ],
        "Phrase": [
            F.ByPhrase("body", [term_at(30 + 2 * i), term_at(31 + 2 * i)])
            for i in range(n)
        ],
        "Prefix": [
            F.ByPrefix("body", p, scored_terms_limit=16)
            for p in ["t01", "t02", "t011", "t021"][: max(1, min(n, 4))]
        ],
        "Fuzzy1": [
            F.ByEditDistance(
                "body", term_at(50 + i), max_distance=1, scored_terms_limit=16
            )
            for i in range(n)
        ],
    }


# --- phases ------------------------------------------------------------


def card_line() -> str:
    """``name, power.limit`` of the card, read by nvidia-smi in a child
    process that does not touch JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def phase_device(count: int):
    import jax

    devs = jax.devices()
    check(
        devs[0].platform == "gpu",
        f"needs a GPU; JAX found {devs[0].platform} ({devs[0].device_kind})",
    )
    check(len(devs) >= count, f"needs {count} GPUs; JAX found {len(devs)}")
    card = card_line()
    say(f"[device] {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}")
    say(f"[device] card: {card}")
    return devs, card


def phase_native():
    t0 = time.perf_counter()
    r = subprocess.run(
        ["make", "-C", os.path.join(REPO, "native")],
        capture_output=True, text=True,
    )
    check(r.returncode == 0, f"make -C native failed:\n{r.stdout}\n{r.stderr}")
    from iresearch_tpu import native

    check(native.load() is not None, "native library did not load")
    say(f"[native] built and loaded in {time.perf_counter() - t0:.3f} s")


def phase_ingest(num_docs: int, seed: int, segments: int):
    t0 = time.perf_counter()
    texts = corpus_texts(num_docs, seed)
    t_gen = time.perf_counter() - t0
    reader, secs = build_index(texts, segments)
    ntok = sum(sr.field("body").total_term_freq for sr in reader.segments)
    say(
        f"[ingest] {num_docs} docs, {ntok} tokens, "
        f"{len(reader.segments)} segments; text generation {t_gen:.3f} s; "
        f"IndexWriter {secs:.3f} s = {num_docs / secs:.1f} docs/s (host time)"
    )
    check(len(reader.segments) >= segments, "reader has too few segments")
    return reader


def oracle(reader, queries, ks):
    """{k: [oracle top-k]} — the exact top-k under the (-score, doc) order
    is a prefix of any larger one, so one search at the largest k serves
    every k."""
    from iresearch_tpu.search.host_eval import search as host_search
    from iresearch_tpu.search.scorers import BM25

    t0 = time.perf_counter()
    top = [host_search(reader, q, BM25(), k=max(ks)) for q in queries]
    say(f"[oracle] {len(queries)} queries, k={max(ks)}: "
        f"{time.perf_counter() - t0:.3f} s (host)")
    return {k: [hits[:k] for hits in top] for k in ks}


def phase_queries(reader, per_category: int, card: str, dev):
    import jax

    from iresearch_tpu.exec.batch import QueryBatch
    from iresearch_tpu.exec.executor import search_device
    from iresearch_tpu.search.scorers import BM25

    cats = category_queries(reader, per_category)
    names = [c for c, qs in cats.items() for _ in qs]
    queries = [q for qs in cats.values() for q in qs]
    ks = (10, 100)
    want = oracle(reader, queries, ks)
    segs = list(reader.segments)
    problems = []
    tiers = None
    for k in ks:
        qb = QueryBatch(queries, segs, BM25(), wand=True)
        t0 = time.perf_counter()
        mb = qb.prepare_all(k)
        t1 = time.perf_counter()
        vals, docs = jax.block_until_ready(mb.run())
        t2 = time.perf_counter()
        say(
            f"[queries] batch k={k}: {len(queries)} queries, prepare "
            f"{t1 - t0:.3f} s (host), first run incl. compile {t2 - t1:.3f} s"
        )
        if k == 10:
            tiers = batch_tiers(mb)
            mix = mb
        vals, docs = np.asarray(vals), np.asarray(docs)
        for qi, q in enumerate(queries):
            for p in compare_topk(hits_of(vals[qi], docs[qi]), want[k][qi], k):
                problems.append(f"batch k={k} {names[qi]} #{qi}: {p}")
    # single-query path: search_device over every segment + host merge
    for cat in ("HighTerm", "AndHighMed", "OrHigh4", "Phrase", "Fuzzy1"):
        qi = names.index(cat)
        for k in ks:
            got = search_device(reader, queries[qi], BM25(), k=k)
            for p in compare_topk(got, want[k][qi], k):
                problems.append(f"search_device k={k} {cat}: {p}")
    for cat in cats:
        qis = [i for i, n in enumerate(names) if n == cat]
        t = sorted(set().union(*(tiers[i] for i in qis)))
        say(f"[tiers] {cat}: {' '.join(t)}")
    miss = missing_tiers(tiers)
    if miss:
        problems.append(f"no query ran these tiers: {miss}")
    if not problems:
        say(f"[queries] all {len(queries)} queries match the oracle at k=10 "
            "and k=100 (batched), and 5 categories through search_device")

    # steady throughput of the whole mix, then per-category latency, k=10
    ms = _readings(mix.run)
    say(f"[latency] whole mix: {_spread(ms)} ms per pass of {len(queries)} "
        f"queries = {len(queries) / np.median(ms) * 1e3:.1f} queries/s "
        f"(k=10) on {card}")
    for cat, qs in cats.items():
        mb = QueryBatch(qs, segs, BM25(), wand=True).prepare_all(10)
        t0 = time.perf_counter()
        jax.block_until_ready(mb.run())
        warm = time.perf_counter() - t0
        ms = [t / len(qs) for t in _readings(mb.run)]
        say(
            f"[latency] {cat}: {_spread(ms)} ms/query (batch of {len(qs)}, "
            f"k=10; warm-up {warm:.3f} s) on {card}"
        )
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    say(f"[memory] peak_bytes_in_use {peak}")
    check(not problems, "\n  ".join(problems[:40]))


def _steady_secs(run, reps: int = 20) -> float:
    """Seconds per call of a warm ``run``: ``reps`` calls enqueued back
    to back, the clock stopped when the device has finished them."""
    import jax

    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _readings(run, n: int = 5, reps: int = 20) -> list:
    """``n`` readings of ``_steady_secs`` in ms per call, so that a
    difference can be weighed against the spread between readings."""
    return [_steady_secs(run, reps) * 1e3 for _ in range(n)]


def _spread(ms) -> str:
    """'median (min-max)' of readings in ms."""
    return f"{np.median(ms):.4f} ({min(ms):.4f}-{max(ms):.4f})"


def _time(fn, *args):
    """(output, first-call seconds, ms-per-call readings) of a jitted ``fn``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    return out, first, _readings(lambda: fn(*args), reps=30)


def phase_kernels(card: str, seed: int, sizes=(1_000_000, 5_000_000)):
    """Time the top-k decision at the grid shapes of ``sizes``-document
    segments — the tournament and ``lax.top_k`` side by side, with the
    one ``wide_top_k`` picks — and check that they agree."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from iresearch_tpu.formats.spec import BLOCK, pad_docs
    from iresearch_tpu.ops.topk import _MIN_WIDTH, _tournament

    rng = np.random.default_rng(seed)
    for docs in sizes:
        nd = pad_docs(docs)
        # the fused scan's refine over row maxima (m = max(2k, 16)), one
        # query's [nd] doc axis (the row a vmapped dense fold sees), and
        # the dense fold's [chunk, nd] batch (exec/batch.py lane budget)
        q_chunk = max(1, min(32, (1 << 25) // nd))
        for shape in ((nd // BLOCK,), (nd,), (q_chunk, nd)):
            x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
            for k in (10, 100):
                m = min(max(2 * k, 16) if len(shape) == 1 else k, shape[-1])
                tour = jax.jit(lambda v, m=m: _tournament(v, m))
                (wv, wi), wf, wms = _time(tour, x)
                (lv, li), lf, lms = _time(jax.jit(lambda v, m=m: lax.top_k(v, m)), x)
                check(
                    np.array_equal(np.asarray(wv), np.asarray(lv))
                    and np.array_equal(np.asarray(wi), np.asarray(li)),
                    f"tournament != lax.top_k at {shape} k={m}",
                )
                picked = "lax.top_k" if shape[-1] < _MIN_WIDTH else "tournament"
                say(
                    f"[kernels] top-k shape={shape} k={m}: tournament "
                    f"{_spread(wms)} ms, lax.top_k {_spread(lms)} ms, "
                    f"wide_top_k picks {picked} (compile {wf:.3f} / {lf:.3f} s) "
                    f"on {card}"
                )


def phase_four_cards(reader, per_category: int, card: str, devs):
    import jax

    from iresearch_tpu.exec.batch import QueryBatch
    from iresearch_tpu.parallel import ShardedSearcher, make_mesh
    from iresearch_tpu.search.scorers import BM25

    cats = category_queries(reader, per_category)
    names = [c for c, qs in cats.items() for _ in qs]
    queries = [q for qs in cats.values() for q in qs]
    # k=10 only: the one-card run checks k=100, and each k compiles its
    # own sharded and one-card programs for minutes on four cards' time
    ks = (10,)
    want = oracle(reader, queries, ks)
    segs = list(reader.segments)
    t0 = time.perf_counter()
    searcher = ShardedSearcher(segs, make_mesh(devs[:4]))
    prep = searcher.prepare_many(queries, BM25(), wand=True)
    say(f"[four-cards] {len(segs)} segments over 4 cards; searcher + prepare "
        f"{time.perf_counter() - t0:.3f} s (host)")
    problems = []
    for k in ks:
        t0 = time.perf_counter()
        jax.block_until_ready(prep.run(k))
        first = time.perf_counter() - t0
        sharded = prep.top_k(k)
        # the one-card result: per-segment batches on the first card and
        # a host merge — equal segments share one compiled program
        t0 = time.perf_counter()
        with jax.default_device(devs[0]):
            one_card = QueryBatch(queries, segs, BM25(), wand=True).search(k)
        say(f"[four-cards] one-card QueryBatch.search k={k}: "
            f"{time.perf_counter() - t0:.3f} s incl. compile")
        for qi in range(len(queries)):
            for p in compare_topk(sharded[qi], want[k][qi], k):
                problems.append(f"sharded k={k} {names[qi]} #{qi}: {p}")
            for p in compare_topk(sharded[qi], one_card[qi], k):
                problems.append(f"sharded vs one card k={k} {names[qi]} #{qi}: {p}")
        ms = _steady_secs(lambda: prep.run(k)) / len(queries) * 1e3
        say(f"[four-cards] k={k}: first run incl. compile {first:.3f} s; "
            f"{ms:.4f} ms/query over the mix (batch of {len(queries)}) on 4x {card}")
    check(not problems, "four-card mismatch:\n  " + "\n  ".join(problems[:40]))
    say(f"[four-cards] all {len(queries)} queries match the oracle and the "
        "one-card QueryBatch at k=10")
    for d in devs[:4]:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use")
        say(f"[memory] {d}: peak_bytes_in_use {peak}")


def run_phase(name: str, failures: list, fn, *args):
    """Run one phase, print its seconds, and record a failure instead of
    raising, so that later independent phases still run."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    except Exception as e:  # reported, and the run exits non-zero
        if not isinstance(e, SmokeFailure):
            traceback.print_exc()
        failures.append(f"{name}: {e}")
        say(f"[phase] {name} FAILED: {e}")
        return None
    finally:
        say(f"[phase] {name} {time.perf_counter() - t0:.3f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--per-category", type=int, default=4)
    ap.add_argument("--four-cards", action="store_true")
    args = ap.parse_args(argv)

    from iresearch_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    count = 4 if args.four_cards else 1
    t_all = time.perf_counter()
    devs, card = phase_device(count)
    failures = []
    run_phase("native", failures, phase_native)
    reader = None
    if not failures:
        segments = 4 if args.four_cards else 2
        reader = run_phase(
            "ingest", failures, phase_ingest, args.docs, args.seed, segments
        )
    if reader is not None and args.four_cards:
        run_phase(
            "four-cards", failures, phase_four_cards, reader,
            args.per_category, card, devs,
        )
    elif reader is not None:
        run_phase(
            "queries", failures, phase_queries, reader, args.per_category,
            card, devs[0],
        )
    if not args.four_cards:
        run_phase("kernels", failures, phase_kernels, card, args.seed)
    say(f"[phase] total {time.perf_counter() - t_all:.3f} s on {card}")
    if failures:
        raise SmokeFailure("; ".join(f.splitlines()[0] for f in failures))
    d = devs[0]
    say(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind, "count": count},
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
