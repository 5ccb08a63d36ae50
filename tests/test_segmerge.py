"""Device-side cross-segment merge (exec/segmerge.py) vs host merge.

MergedBatch.run() must equal the host-merge reference
(QueryBatch.search) exactly: same global docs in deterministic
(score desc, doc asc) order, scores to float tolerance. Covers the
multi-segment bench path (bench.py BENCH_SEG_DOCS) through library
code.
"""

import numpy as np
import pytest

from iresearch_tpu.index.reader import DirectoryReader
from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.scorers import BM25, TFIDF
from iresearch_tpu.store.directory import MemoryDirectory

WORDS = [
    "one", "two", "three", "four", "five",
    "six", "seven", "eight", "nine", "ten",
]


@pytest.fixture(scope="module")
def reader():
    rng = np.random.default_rng(11)
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(300):
            n = int(rng.integers(2, 15))
            idx = np.minimum(rng.zipf(1.5, size=n) - 1, len(WORDS) - 1)
            w.insert([
                Field(
                    "body",
                    " ".join(WORDS[j] for j in idx),
                    analyzer="segmentation",
                )
            ])
            if i in (90, 210):
                w.commit()  # three segments of different sizes
        w.commit()
    return DirectoryReader.open(d)


def _filters():
    return (
        [F.ByTerm("body", w) for w in WORDS[:6]]
        + [F.Or(F.ByTerm("body", "one"), F.ByTerm("body", "nine"))]
        + [F.And(F.ByTerm("body", "one"), F.ByTerm("body", "three"))]
        + [F.Or(*[F.ByTerm("body", w) for w in WORDS[:4]])]
    )


@pytest.mark.parametrize("scorer", [BM25(), TFIDF()])
def test_merged_batch_equals_host_merge(reader, scorer):
    from iresearch_tpu.exec.batch import QueryBatch

    segs = list(reader.segments)
    assert len(segs) == 3
    k = 7
    qb = QueryBatch(_filters(), segs, scorer, wand=True)
    got = qb.prepare_all(k).search(k)
    ref = qb.search(k)
    for qi, (g, r) in enumerate(zip(got, ref)):
        assert len(g) == len(r), (qi, g, r)
        for j, ((gd, gv), (rd, rv)) in enumerate(zip(g, r)):
            assert gd == rd, (qi, j, g, r)
            assert gv == pytest.approx(rv, rel=1e-5), (qi, j, g, r)


def test_merged_batch_deterministic_tie_order(reader):
    """Equal-score docs must come out (score desc, doc asc) — the
    per-segment top-k emits survivor-row order, the merge restores the
    engine-wide deterministic order."""
    from iresearch_tpu.exec.batch import QueryBatch

    segs = list(reader.segments)
    qb = QueryBatch(_filters(), segs, BM25(), wand=True)
    res = qb.prepare_all(10).search(10)
    for q in res:
        for (d0, v0), (d1, v1) in zip(q, q[1:]):
            assert v0 > v1 or (v0 == v1 and d0 < d1), q


def test_tiny_segment_pads_to_requested_k():
    """A segment whose padded doc count is below the requested k clamps
    its per-group top-k to k' < k; the device merge must pad that
    group's output back to [Qg, k] with (-inf, 0) instead of raising a
    shape mismatch (a normal pre-consolidation index has tiny fresh
    segments next to big consolidated ones)."""
    from iresearch_tpu.exec.batch import QueryBatch

    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        rng = np.random.default_rng(3)
        for i in range(60):
            n = int(rng.integers(3, 12))
            idx = np.minimum(rng.zipf(1.4, size=n) - 1, len(WORDS) - 1)
            w.insert([
                Field(
                    "body",
                    " ".join(WORDS[j] for j in idx),
                    analyzer="segmentation",
                )
            ])
        w.commit()
        for i in range(4):  # 4-doc tail segment: nd_pad < k=10
            w.insert([
                Field(
                    "body",
                    " ".join(WORDS[j % 5] for j in range(i, i + 4)),
                    analyzer="segmentation",
                )
            ])
        w.commit()
    r = DirectoryReader.open(d)
    segs = list(r.segments)
    assert len(segs) == 2 and segs[1].num_docs == 4
    qb = QueryBatch(_filters(), segs, BM25(), wand=True)
    got = qb.prepare_all(10).search(10)  # crashed before the pad fix
    ref = qb.search(10)
    for qi, (g, rf) in enumerate(zip(got, ref)):
        assert [dd for dd, _ in g] == [dd for dd, _ in rf], qi
        for (gd, gv), (rd, rv) in zip(g, rf):
            assert gv == pytest.approx(rv, rel=1e-5)


@pytest.mark.parametrize("scorer", [BM25()])
def test_fused_pass_equals_per_segment_dispatch(reader, scorer):
    """run(fused=True) — one jitted program covering every segment's
    bodies plus the merge — must produce bit-identical results to the
    per-segment dispatch path (fused=False), and hit the global fused
    cache on re-run."""
    from iresearch_tpu.exec import batch as B
    from iresearch_tpu.exec.batch import QueryBatch

    segs = list(reader.segments)
    qb = QueryBatch(_filters(), segs, scorer, wand=True)
    mb = qb.prepare_all(7)
    v1, d1 = (np.asarray(a) for a in mb.run(fused=True))
    v0, d0 = (np.asarray(a) for a in mb.run(fused=False))
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(v1, v0)
    # the fused program is cached by per-segment template keys
    fkey = ("segfused", tuple(p._key for p in mb.preps), 7)
    assert fkey in B._FUSED_CACHE
    # a fresh MergedBatch of the same structure reuses the cached program
    mb2 = QueryBatch(_filters(), segs, scorer, wand=True).prepare_all(7)
    before = B._FUSED_CACHE[fkey]
    v2, d2 = (np.asarray(a) for a in mb2.run(fused=True))
    assert B._FUSED_CACHE[fkey] is before
    np.testing.assert_array_equal(d2, d0)


def test_merged_batch_rejects_int32_overflow():
    from iresearch_tpu.exec.segmerge import MergedBatch

    with pytest.raises(ValueError):
        MergedBatch([object(), object()], [2**30, 2**30 + 7])


def test_equal_shape_segments_share_fused_executable():
    """Equal-size segments of one corpus (the post-consolidation shape)
    must stack to IDENTICAL fused programs under prepare_all: the joint
    cross-segment signature grouping + cross-segment max padding makes
    every per-segment PreparedBatch carry the same template key, so one
    compiled executable serves all segments (the compiled program count
    is O(1) in segments, not O(S))."""
    from iresearch_tpu.exec.batch import QueryBatch

    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for s in range(3):
            # near-identical document streams per segment: term dfs (hence
            # pool bit-width classes and _bucket4 row buckets) agree, the
            # shape-sharing precondition that equal-size segments of one
            # corpus approach statistically. Segment 1 gets extra docs so
            # its per-term row counts DIFFER within the shared buckets —
            # the cross-segment max padding (_joint_pad) must absorb that.
            rng = np.random.default_rng(5)
            for i in range(200):
                n = int(rng.integers(4, 15))
                idx = np.minimum(rng.zipf(1.4, size=n) - 1, len(WORDS) - 1)
                w.insert([
                    Field(
                        "body",
                        " ".join(WORDS[j] for j in idx),
                        analyzer="segmentation",
                    )
                ])
            if s == 1:
                for i in range(24):
                    w.insert([
                        Field(
                            "body",
                            " ".join(WORDS[(i + j) % 6] for j in range(6)),
                            analyzer="segmentation",
                        )
                    ])
            w.commit()
    r = DirectoryReader.open(d)
    segs = list(r.segments)
    assert len(segs) == 3
    qb = QueryBatch(_filters(), segs, BM25(), wand=True)
    mb = qb.prepare_all(7)
    keys = {p._key for p in mb.preps}
    assert len(keys) == 1, (
        f"{len(keys)} distinct fused keys across equal-shape segments"
    )
    # stacked/packed host-array shapes must match EVERYWHERE — that is
    # _joint_pad's guarantee (cross-segment max padding)
    bufs = [
        tuple((kk, v.shape) for kk, v in sorted(p._buffers.items()))
        for p in mb.preps
    ]
    assert bufs[0] == bufs[1] == bufs[2]
    # full executable signature (incl. pool dev-arg shapes) matches for
    # the two truly identical segments; segment 1's larger pools may
    # cross a pow2 bucket at this toy scale (at 5M docs pow2 pool
    # buckets are wide and equal-size segments coincide)
    shp = [
        tuple((a.shape, str(a.dtype)) for a in p._dev_args)
        for p in mb.preps
    ]
    assert shp[0] == shp[2]
    # and results must stay exact vs the host merge
    got = mb.search(7)
    ref = qb.search(7)
    for g, r_ in zip(got, ref):
        assert [dd for dd, _ in g] == [dd for dd, _ in r_]
