"""WAND speed/recall modes: exact (default) vs strict vs approx.

Reference analog: WandContext{index, strict}
(/root/reference/core/index/index_reader_options.hpp:48-56) — strict
sets the skip threshold to the score as-is (MinStrict,
formats_10.cpp:2434), weak backs it off one float step (MinWeak). The
engine's "exact" default goes further (relative-epsilon shave =
never prunes a true top-k block); "strict" matches the reference's
aggressive bound; "approx" is the speed lever — a single
sampled pass decoding only the `wand_sample` highest-bound blocks.
"""

import numpy as np
import pytest

from iresearch_tpu.index.reader import DirectoryReader
from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.scorers import BM25
from iresearch_tpu.store.directory import MemoryDirectory

WORDS = [f"w{i:02d}" for i in range(40)]


@pytest.fixture(scope="module")
def reader():
    rng = np.random.default_rng(77)
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for _ in range(3000):
            n = int(rng.integers(3, 40))
            idx = np.minimum(rng.zipf(1.3, size=n) - 1, len(WORDS) - 1)
            w.insert(
                [Field("body", " ".join(WORDS[j] for j in idx),
                       analyzer="segmentation")]
            )
        w.commit()
    return DirectoryReader.open(d)


QUERIES = [
    F.ByTerm("body", "w00"),
    F.ByTerms("body", [("w00", 1.0), ("w03", 2.0), ("w11", 1.0)]),
    F.Or(F.ByTerm("body", "w00"), F.ByTerm("body", "w01"),
         F.ByTerm("body", "w07")),
]


def _force_wand(monkeypatch):
    import iresearch_tpu.exec.plan as planmod

    monkeypatch.setattr(planmod, "JOIN_MAX_SPANS", 0)


def test_bad_mode_rejected(reader):
    with pytest.raises(ValueError):
        from iresearch_tpu.exec import DeviceQuery

        DeviceQuery(QUERIES[0], list(reader.segments), BM25(),
                    wand=True, wand_mode="fuzzy")


@pytest.mark.parametrize("flt", QUERIES, ids=lambda f: type(f).__name__)
def test_strict_mode_near_exact(reader, flt, monkeypatch):
    """Strict may only lose score-ties at θ within float-reorder ulps:
    the returned score vector must match exact's within rtol, and doc
    overlap must be >= k-1 (a tie swap at the boundary at worst)."""
    from iresearch_tpu.exec import DeviceQuery

    _force_wand(monkeypatch)
    k = 10
    segs = list(reader.segments)
    exact = DeviceQuery(flt, segs, BM25(), wand=True, wand_sample=8)
    strict = DeviceQuery(flt, segs, BM25(), wand=True, wand_sample=8,
                         wand_mode="strict")
    ev, ed = exact.execute_segment(0, k)
    sv, sd = strict.execute_segment(0, k)
    finite = np.isfinite(ev)
    assert np.isfinite(sv).sum() >= finite.sum() - 1
    n = min(finite.sum(), np.isfinite(sv).sum())
    np.testing.assert_allclose(sv[:n], ev[:n], rtol=1e-4)
    assert len(set(sd[:n].tolist()) & set(ed[:n].tolist())) >= n - 1


@pytest.mark.parametrize("flt", QUERIES, ids=lambda f: type(f).__name__)
def test_approx_mode_lower_bounds_and_recall(reader, flt, monkeypatch):
    """Approx scores are lower bounds of the true scores and recall@10
    stays useful at sample=8 of ~24 blocks."""
    from iresearch_tpu.exec import DeviceQuery

    _force_wand(monkeypatch)
    k = 10
    segs = list(reader.segments)
    exact = DeviceQuery(flt, segs, BM25(), wand=False)
    approx = DeviceQuery(flt, segs, BM25(), wand=True, wand_sample=8,
                         wand_mode="approx")
    ev, ed = exact.execute_segment(0, k)
    av, ad = approx.execute_segment(0, k)
    exact_scores = {int(d): float(v) for d, v in zip(ed, ev)
                    if np.isfinite(v)}
    # every approx score is <= the doc's true score (partial decode can
    # only shrink contributions); spot-checkable only for docs in both
    hits = 0
    for d, v in zip(ad, av):
        if not np.isfinite(v):
            continue
        if int(d) in exact_scores:
            hits += 1
            assert v <= exact_scores[int(d)] * (1 + 1e-5) + 1e-6
    assert hits >= k // 2, f"recall@{k} too low: {hits}/{k}"


@pytest.mark.parametrize("flt", QUERIES, ids=lambda f: type(f).__name__)
def test_approx_full_sample_is_exact(reader, flt, monkeypatch):
    """With wand_sample >= all blocks the sampled pass IS the full pass,
    so approx degenerates to exact output."""
    from iresearch_tpu.exec import DeviceQuery
    from tests.topk_util import assert_topk_equiv

    _force_wand(monkeypatch)
    k = 10
    segs = list(reader.segments)
    exact = DeviceQuery(flt, segs, BM25(), wand=False)
    approx = DeviceQuery(flt, segs, BM25(), wand=True, wand_sample=4096,
                         wand_mode="approx")
    ev, ed = exact.execute_segment(0, k)
    av, ad = approx.execute_segment(0, k)
    finite = np.isfinite(ev)
    np.testing.assert_array_equal(np.isfinite(av), finite)
    np.testing.assert_allclose(av[finite], ev[finite], rtol=1e-6)
    assert_topk_equiv(
        [(int(d), float(v)) for d, v in zip(ad[finite], av[finite])],
        [(int(d), float(v)) for d, v in zip(ed[finite], ev[finite])],
    )


def test_batch_modes_sound_vs_exact(reader, monkeypatch):
    """QueryBatch threads wand_mode through the stacked dispatch. The
    batched path may pick a different tier than the single-query path
    (where approx prunes differently), so assert mode SEMANTICS against
    the exact result rather than path-equality: strict scores match
    exact within float-reorder tolerance; approx scores are lower
    bounds with useful recall."""
    from iresearch_tpu.exec import DeviceQuery
    from iresearch_tpu.exec.batch import QueryBatch

    _force_wand(monkeypatch)
    k = 10
    segs = list(reader.segments)
    exact_res = [
        DeviceQuery(f, segs, BM25(), wand=False).execute_segment(0, k)
        for f in QUERIES
    ]
    for mode in ("strict", "approx"):
        qb = QueryBatch(QUERIES, segs, BM25(), wand=True, wand_sample=8,
                        wand_mode=mode)
        batched = qb.execute_segment(0, k)
        for (ev, ed), (bv, bd) in zip(exact_res, batched):
            bv, bd = np.asarray(bv), np.asarray(bd)
            exact_scores = {int(d): float(v) for d, v in zip(ed, ev)
                            if np.isfinite(v)}
            if mode == "strict":
                fin = np.isfinite(ev)
                n = min(fin.sum(), np.isfinite(bv).sum())
                np.testing.assert_allclose(bv[:n], ev[:n], rtol=1e-4)
            else:
                hits = 0
                for d, v in zip(bd, bv):
                    if not np.isfinite(v):
                        continue
                    if int(d) in exact_scores:
                        hits += 1
                        assert v <= exact_scores[int(d)] * (1 + 1e-5) + 1e-6
                assert hits >= k // 2
