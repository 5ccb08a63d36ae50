"""Sharded execution with the uniform dense-grid layout
(parallel/dense_stack.py): dense/gridmix tiers + WAND under shard_map
must stay exact vs the host oracle (VERDICT r2 item 5).
"""

import numpy as np
import pytest

from iresearch_tpu.index.reader import DirectoryReader
from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.host_eval import search as search_host
from iresearch_tpu.search.scorers import BM25, TFIDF
from iresearch_tpu.store.directory import MemoryDirectory
from tests.topk_util import assert_topk_equiv

RARE = ["rook", "pawn", "king", "vizier", "knight", "bishop"]


@pytest.fixture(scope="module")
def reader():
    """8 segments x 128 docs (the grid needs 128-lane alignment); hot
    terms qualify for the dense grid in every shard (df >= 32 of 128
    docs/segment); 'hotpart' exists only in the first 4 segments
    (absent-shard zero-row path)."""
    rng = np.random.default_rng(23)
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(1024):
            toks = []
            if rng.random() < 0.85:
                toks += ["hot1"] * int(rng.integers(1, 4))
            if rng.random() < 0.7:
                toks.append("hot2")
            if i < 512 and rng.random() < 0.8:
                toks.append("hotpart")
            toks += [RARE[int(x)] for x in rng.integers(0, len(RARE), size=3)]
            rng.shuffle(toks)
            w.insert([
                Field("body", " ".join(toks) or "empty", analyzer="segmentation"),
            ])
            if i % 128 == 127:
                w.commit()
        w.commit()
    return DirectoryReader.open(d)


@pytest.fixture(scope="module")
def searcher(reader):
    import jax

    from iresearch_tpu.parallel import ShardedSearcher, make_mesh

    assert len(jax.devices()) == 8
    return ShardedSearcher(list(reader.segments), make_mesh())


def test_dense_layout_nonempty(reader, searcher):
    lay = searcher._dense_layout("body")
    assert b"hot1" in lay.terms and b"hot2" in lay.terms
    assert b"hotpart" in lay.terms  # absent shards are fine
    # uniform term-keyed starts, zero region at [0, stride)
    assert all(s >= lay.stride for s in lay.start.values())


DENSE_QUERIES = [
    F.ByTerm("body", "hot1"),
    F.ByTerm("body", "hotpart"),  # absent in shards 4-7
    F.Or(F.ByTerm("body", "hot1"), F.ByTerm("body", "hot2")),
    F.Or(F.ByTerm("body", "hot1"), F.ByTerm("body", "rook")),  # gridmix mix
    F.And(F.ByTerm("body", "hot1"), F.ByTerm("body", "pawn")),
    F.And(F.ByTerm("body", "hot1"), F.ByTerm("body", "hot2")),
    F.Or(
        F.ByTerm("body", "hotpart"),
        F.ByTerm("body", "hot2"),
        F.ByTerm("body", "king"),
        min_match=2,
    ),
]


@pytest.mark.parametrize("wand", [False, True], ids=["plain", "wand"])
@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
def test_sharded_dense_equals_host(reader, searcher, scorer, wand):
    prep = searcher.prepare_many(DENSE_QUERIES, scorer, wand=wand)
    got = prep.top_k(10)
    for flt, hits in zip(DENSE_QUERIES, got):
        want = search_host(reader, flt, scorer, k=10)
        assert_topk_equiv(hits, want)


def test_dense_pools_actually_used(searcher):
    prep = searcher.prepare_many([F.ByTerm("body", "hot1")], BM25())
    # args index 8 = dense_shared: the stacked uniform grid pools
    assert any(len(args[8]) > 0 for _qis, args, _st, _l in prep._calls)


def test_scored_only_kmax_enforced(reader, searcher):
    flt = F.ByPrefix("body", "hot", scored_terms_limit=1)
    prep = searcher.prepare_many([flt], BM25(), k_max=16)
    if prep._kmax is not None:
        with pytest.raises(ValueError):
            prep.run(prep._kmax + 1)
    got = prep.top_k(10)[0]
    want = search_host(reader, flt, BM25(), k=10)
    assert_topk_equiv(got, want)


@pytest.mark.parametrize("wand", [False, True], ids=["exact", "wand"])
def test_sharded_dense_unaligned_segment_grid(wand):
    """Segments whose padded grid is not a power of two (pad_docs rounds
    9000 docs to 9216, the sharded doc axis to 16384): the uniform layout
    zero-pads every term's rows to the sharded axis and stays exact."""
    import jax

    from iresearch_tpu.formats.spec import pad_docs
    from iresearch_tpu.parallel import ShardedSearcher, make_mesh

    rng = np.random.default_rng(31)
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(18000):
            toks = ["hot1"] * int(rng.integers(0, 3))
            if rng.random() < 0.6:
                toks.append("hot2")
            toks.append(RARE[int(rng.integers(0, len(RARE)))])
            w.insert([Field("body", " ".join(toks), analyzer="segmentation")])
            if i == 8999:
                w.commit()
        w.commit()
    r = DirectoryReader.open(d)
    segs = list(r.segments)
    assert [sr.num_docs for sr in segs] == [9000, 9000]
    assert pad_docs(9000) == 9216
    s = ShardedSearcher(segs, make_mesh(jax.devices()[:2]))
    lay = s._dense_layout("body")
    assert b"hot1" in lay.terms and lay.stride * 128 == s.nd_pad == 16384
    qs = [
        F.ByTerm("body", "hot1"),
        F.Or(F.ByTerm("body", "hot1"), F.ByTerm("body", "hot2")),
        F.Or(F.ByTerm("body", "hot2"), F.ByTerm("body", "rook")),
    ]
    got = s.prepare_many(qs, BM25(), wand=wand).top_k(10)
    for q, g in zip(qs, got):
        assert_topk_equiv(g, search_host(r, q, BM25(), k=10))
