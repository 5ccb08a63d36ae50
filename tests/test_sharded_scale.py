"""--runslow: sharded execution at non-toy scale (VERDICT r2 item 5).

8 segments x 131072 docs (1.05M total) on the virtual CPU mesh: the
dense grid, gridmix and WAND paths run with realistic tier thresholds
(a toy corpus exercises different plan shapes than 100k+ docs/shard).
Catches tier/threshold regressions before they cost a benchmark round on the card
(VERDICT r2 weak item 8).
"""

import numpy as np
import pytest

from iresearch_tpu.formats.postings import encode_field_postings
from iresearch_tpu.formats.spec import IndexFeatures
from iresearch_tpu.index.invert import invert_numpy
from iresearch_tpu.index.segment import SegmentData, SegmentReader
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.host_eval import HostQuery
from iresearch_tpu.search.scorers import BM25
from tests.topk_util import assert_topk_equiv

SEGS = 8
DOCS_PER_SEG = 131_072
VOCAB = 20_000


def _build_segment(seed: int, n_docs: int = DOCS_PER_SEG) -> SegmentReader:
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 24, size=n_docs)
    total = int(lens.sum())
    tids = np.minimum(
        rng.zipf(1.3, size=total) - 1, VOCAB - 1
    ).astype(np.int64)
    doc = np.repeat(np.arange(n_docs), lens)
    starts = np.cumsum(lens) - lens
    pos = (
        np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
    ).astype(np.uint32)
    inv = invert_numpy(tids, doc, pos, VOCAB, n_docs)
    present = np.flatnonzero(np.diff(inv.term_ptr) > 0)
    terms_l = [b"t%05d" % t for t in present]
    blob = b"".join(terms_l)
    offs = np.zeros(len(terms_l) + 1, np.uint64)
    offs[1:] = np.cumsum([len(t) for t in terms_l])
    tp = np.concatenate([inv.term_ptr[present], [inv.term_ptr[-1]]])
    fp = encode_field_postings(
        inv.e_doc, inv.e_freq, tp, blob, offs, inv.norms, inv.pos_flat,
        IndexFeatures.FREQ | IndexFeatures.POS,
    )
    return SegmentReader(f"s{seed}", SegmentData(n_docs, {"body": fp}, {}))


@pytest.fixture(scope="module")
def segs():
    return [_build_segment(100 + i) for i in range(SEGS)]


@pytest.mark.slow
def test_sharded_scale_equals_host(segs):
    import jax

    from iresearch_tpu.parallel import ShardedSearcher, make_mesh

    assert len(jax.devices()) == 8
    searcher = ShardedSearcher(segs, make_mesh())
    # the dense grid must be active at this scale (hot zipf terms)
    assert searcher._dense_layout("body").terms
    queries = [
        F.ByTerm("body", "t00000"),  # hottest: dense
        F.ByTerm("body", "t05000"),  # mid: sparse tiers
        F.Or(F.ByTerm("body", "t00001"), F.ByTerm("body", "t00002")),
        F.Or(F.ByTerm("body", "t00000"), F.ByTerm("body", "t09000")),
        F.And(F.ByTerm("body", "t00000"), F.ByTerm("body", "t06000")),
        F.ByPrefix("body", "t001", scored_terms_limit=16),
    ]
    prep = searcher.prepare_many(queries, BM25(), wand=True)
    got = prep.top_k(10)
    for flt, hits in zip(queries, got):
        want = HostQuery(flt, segs, BM25()).top_k(10)
        assert_topk_equiv(hits, want)


MID_DOCS = 16_384  # default-CI scale: dense/gridmix tiers engage for real


@pytest.fixture(scope="module")
def segs_mid():
    return [_build_segment(200 + i, MID_DOCS) for i in range(SEGS)]


def test_sharded_midscale_default_ci(segs_mid):
    """Non-slow sharded coverage at non-toy scale (VERDICT r3 weak #8):
    131k docs over 8 shards, where tier selection matches production
    (hot terms clear the df >= nd/128 dense bar); includes the
    single-query prepare() path, which must route through the same
    dense machinery as prepare_many (VERDICT r3 item 4)."""
    import jax

    from iresearch_tpu.parallel import ShardedSearcher, make_mesh

    assert len(jax.devices()) == 8
    searcher = ShardedSearcher(segs_mid, make_mesh())
    assert searcher._dense_layout("body").terms, "dense grid inactive"
    queries = [
        F.ByTerm("body", "t00000"),  # hottest: dense
        F.Or(F.ByTerm("body", "t00001"), F.ByTerm("body", "t00002")),
        F.Or(F.ByTerm("body", "t00000"), F.ByTerm("body", "t04000")),
        F.And(F.ByTerm("body", "t00000"), F.ByTerm("body", "t03000")),
    ]
    prep = searcher.prepare_many(queries, BM25(), wand=True)
    got = prep.top_k(10)
    for flt, hits in zip(queries, got):
        want = HostQuery(flt, segs_mid, BM25()).top_k(10)
        assert_topk_equiv(hits, want)
    # single prepared query: same tiers as prepare_many with Q=1
    single = searcher.prepare(queries[0], BM25())
    assert_topk_equiv(
        single.top_k(10), HostQuery(queries[0], segs_mid, BM25()).top_k(10)
    )
