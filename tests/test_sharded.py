"""Sharded (multi-device) search vs host oracle on the 8-device CPU mesh.

The conftest forces JAX_PLATFORMS=cpu with 8 virtual devices; this is the
CI stand-in for a multi-card host. Exactness gate: sharded top-k must equal
the single-host oracle's top-k (same docs, same order, scores to rtol).
"""

import numpy as np
import pytest

from iresearch_tpu.index.reader import DirectoryReader
from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.host_eval import search as search_host
from iresearch_tpu.search.scorers import BM25, TFIDF
from iresearch_tpu.store.directory import MemoryDirectory

WORDS = [
    "ant", "bee", "cat", "dog", "elk", "fox", "gnu", "hen", "ibis", "jay",
    "kite", "lark", "mole", "newt", "owl", "pig", "quail", "rat", "seal", "toad",
]


@pytest.fixture(scope="module")
def reader():
    rng = np.random.default_rng(11)
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(400):
            n = int(rng.integers(2, 20))
            idx = np.minimum(rng.zipf(1.5, size=n) - 1, len(WORDS) - 1)
            text = " ".join(WORDS[j] for j in idx)
            w.insert([
                Field("body", text, analyzer="segmentation"),
                Field("id", str(i), index=True, store=True),
            ])
            if i % 65 == 64:
                w.commit()  # several segments so sharding is non-trivial
        w.commit()
        w.remove(F.ByTerm("id", "13"))
        w.commit()
    return DirectoryReader.open(d)


@pytest.fixture(scope="module")
def searcher(reader):
    import jax
    from iresearch_tpu.parallel import ShardedSearcher, make_mesh

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return ShardedSearcher(list(reader.segments), make_mesh())


QUERIES = [
    F.ByTerm("body", "fox"),
    F.ByTerm("body", "toad"),
    F.Or(F.ByTerm("body", "fox"), F.ByTerm("body", "dog")),
    F.And(F.ByTerm("body", "ant"), F.ByTerm("body", "bee")),
    F.Or(F.ByTerm("body", "ant"), F.ByTerm("body", "bee"), F.ByTerm("body", "cat"), min_match=2),
    F.ByPrefix("body", "s"),
    F.And(F.ByTerm("body", "ant"), F.Not(F.ByTerm("body", "cat"))),
    F.ByPhrase("body", ["ant", "bee"]),
]


@pytest.mark.parametrize("flt", QUERIES, ids=lambda f: type(f).__name__ + repr(id(f))[-4:])
@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
def test_sharded_equals_host(reader, searcher, flt, scorer):
    from tests.topk_util import assert_topk_equiv

    want = search_host(reader, flt, scorer, k=10)
    got = searcher.search(flt, scorer, k=10)
    assert_topk_equiv(got, want)


def test_prepared_sharded_query(reader, searcher):
    """prepare() uploads once; repeated run() returns identical results."""
    from tests.topk_util import assert_topk_equiv

    flt = F.Or(F.ByTerm("body", "fox"), F.ByTerm("body", "hen"))
    pq = searcher.prepare(flt, BM25())
    a = pq.top_k(6)
    b = pq.top_k(6)
    assert a == b
    want = search_host(reader, flt, BM25(), k=6)
    assert_topk_equiv(a, want)


def test_batched_wand_sharded(reader, searcher):
    """SURVEY §2.11 items 1+2 combined: many queries stacked per
    shard_map dispatch with per-query WAND θ — exact vs the host oracle
    for term/Or/And/min_match/prefix/phrase under deletes."""
    from tests.topk_util import assert_topk_equiv

    queries = QUERIES + [
        F.Or(*[F.ByTerm("body", w) for w in ("fox", "dog", "owl", "rat")]),
        F.ByTerm("body", "quail"),
    ]
    prep = searcher.prepare_many(queries, BM25(), wand=True)
    got = prep.top_k(10)
    for flt, hits in zip(queries, got):
        want = search_host(reader, flt, BM25(), k=10)
        assert_topk_equiv(hits, want)
    # repeat dispatch returns identical results (device-resident reuse)
    again = prep.top_k(10)
    assert got == again


def test_batched_sharded_no_wand_matches_wand(reader, searcher):
    prep_a = searcher.prepare_many(QUERIES[:5], BM25(), wand=False)
    prep_b = searcher.prepare_many(QUERIES[:5], BM25(), wand=True)
    a = prep_a.top_k(10)
    b = prep_b.top_k(10)
    for qa, qb in zip(a, b):
        assert [d for d, _ in qa] == [d for d, _ in qb]
        for (_, sa), (_, sb) in zip(qa, qb):
            assert sa == pytest.approx(sb, rel=2e-5)


def test_more_segments_than_devices(reader):
    """S > D exercises the per_shard loop."""
    from iresearch_tpu.parallel import ShardedSearcher, make_mesh
    import jax

    mesh = make_mesh(jax.devices()[:2])
    s = ShardedSearcher(list(reader.segments), mesh)
    assert s.per_shard >= 2
    flt = F.Or(F.ByTerm("body", "fox"), F.ByTerm("body", "owl"))
    want = search_host(reader, flt, BM25(), k=7)
    got = s.search(flt, BM25(), k=7)
    from tests.topk_util import assert_topk_equiv

    assert_topk_equiv(got, want)
