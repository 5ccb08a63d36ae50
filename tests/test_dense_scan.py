"""Fused dense-scan kernel vs the straightforward numpy computation."""

import numpy as np
import pytest

from iresearch_tpu.formats.bitpack import BITS, pack_blocks
from iresearch_tpu.formats.spec import BLOCK
from iresearch_tpu.ops.dense_scan import dense_scan_rowmax_xla, dense_scan_topk
from iresearch_tpu.search.scorers import BM25, TFIDF


def _mk_span(rng, ndrows, bits):
    freqs = rng.integers(0, 1 << bits, size=(ndrows, BLOCK)).astype(np.uint32)
    # make some rows empty so -inf rows are exercised
    freqs[rng.integers(0, ndrows, size=max(1, ndrows // 4))] = 0
    return freqs, pack_blocks(freqs, bits)


@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
@pytest.mark.parametrize("span_bits", [(4,), (8, 4), (2, 8, 16)])
def test_rowmax_matches_numpy(scorer, span_bits):
    rng = np.random.default_rng(5)
    ndrows = 64
    spans = [_mk_span(rng, ndrows, b) for b in span_bits]
    ws = [1.0 + 0.5 * i for i in range(len(span_bits))]
    norms = rng.integers(1, 90, size=(ndrows, BLOCK)).astype(np.float32)
    avgdl = 47.3

    from iresearch_tpu.search.scorers import score_block

    total = np.zeros((ndrows, BLOCK), np.float32)
    fsum = np.zeros((ndrows, BLOCK), np.float32)
    for (freqs, _), w in zip(spans, ws):
        f = freqs.astype(np.float32)
        total += score_block(scorer, np.float32(w), f, norms, avgdl, xp=np)
        fsum += f
    expect = np.where(fsum > 0, total, -np.inf)
    want_max = expect.max(axis=1)
    want_arg = expect.argmax(axis=1)

    got_max, got_arg = dense_scan_rowmax_xla(
        tuple(p for _, p in spans),
        tuple(np.float32(w) for w in ws),
        norms,
        np.float32(avgdl),
        scorer=scorer,
        span_bits=span_bits,
    )
    np.testing.assert_allclose(
        np.asarray(got_max), want_max, rtol=1e-5, atol=1e-6
    )
    finite = np.isfinite(want_max)
    np.testing.assert_array_equal(np.asarray(got_arg)[finite], want_arg[finite])


@pytest.mark.parametrize("k", [1, 10, 40])
def test_topk_matches_sorted(k):
    rng = np.random.default_rng(9)
    ndrows = 32
    span_bits = (8, 4)
    spans = [_mk_span(rng, ndrows, b) for b in span_bits]
    ws = [1.0, 2.5]
    norms = rng.integers(1, 90, size=(ndrows, BLOCK)).astype(np.float32)
    avgdl = 31.0

    from iresearch_tpu.search.scorers import score_block

    total = np.zeros((ndrows, BLOCK), np.float32)
    fsum = np.zeros((ndrows, BLOCK), np.float32)
    for (freqs, _), w in zip(spans, ws):
        f = freqs.astype(np.float32)
        total += score_block(scorer=BM25(), weights=np.float32(w), freqs=f,
                             dl=norms, avgdl=avgdl, xp=np)
        fsum += f
    flat = np.where(fsum > 0, total, -np.inf).reshape(-1)
    order = sorted(range(len(flat)), key=lambda i: (-flat[i], i))
    want = [(flat[i], i) for i in order[:k] if np.isfinite(flat[i])]

    vals, docs = dense_scan_topk(
        tuple(p for _, p in spans),
        tuple(np.float32(w) for w in ws),
        norms,
        np.float32(avgdl),
        scorer=BM25(),
        span_bits=span_bits,
        k=k,
    )
    vals = np.asarray(vals)
    docs = np.asarray(docs)
    for i, (wv, wd) in enumerate(want):
        assert vals[i] == pytest.approx(wv, rel=1e-6), i
        assert docs[i] == wd, (i, docs[i], wd)
    for i in range(len(want), k):
        assert not np.isfinite(vals[i])


@pytest.mark.parametrize("mm", [2, 3])
def test_topk_min_match(mm):
    """mm >= 2: only docs hit by at least mm spans match; score still
    sums every hitting span (the fused analog of the reference's
    min-match pruning, disjunction.hpp:860-1100)."""
    rng = np.random.default_rng(13)
    ndrows = 32
    span_bits = (8, 4, 4)
    spans = [_mk_span(rng, ndrows, b) for b in span_bits]
    # sparsify spans so hit counts vary per lane
    for freqs, _ in spans:
        freqs[rng.random(freqs.shape) < 0.5] = 0
    spans = [(f, pack_blocks(f, b)) for (f, _), b in zip(spans, span_bits)]
    ws = [1.0, 2.5, 0.7]
    norms = rng.integers(1, 90, size=(ndrows, BLOCK)).astype(np.float32)
    avgdl = 31.0
    k = 10

    from iresearch_tpu.search.scorers import score_block

    total = np.zeros((ndrows, BLOCK), np.float32)
    cnt = np.zeros((ndrows, BLOCK), np.int32)
    for (freqs, _), w in zip(spans, ws):
        f = freqs.astype(np.float32)
        total += score_block(scorer=BM25(), weights=np.float32(w), freqs=f,
                             dl=norms, avgdl=avgdl, xp=np)
        cnt += (f > 0).astype(np.int32)
    flat = np.where(cnt >= mm, total, -np.inf).reshape(-1)
    order = sorted(range(len(flat)), key=lambda i: (-flat[i], i))
    want = [(flat[i], i) for i in order[:k] if np.isfinite(flat[i])]

    vals, docs = dense_scan_topk(
        tuple(p for _, p in spans),
        tuple(np.float32(w) for w in ws),
        norms,
        np.float32(avgdl),
        scorer=BM25(),
        span_bits=span_bits,
        k=k,
        mm=mm,
    )
    vals = np.asarray(vals)
    docs = np.asarray(docs)
    assert want, "test corpus must produce mm-matches"
    for i, (wv, wd) in enumerate(want):
        assert vals[i] == pytest.approx(wv, rel=1e-6), i
        assert docs[i] == wd, (i, docs[i], wd)
    for i in range(len(want), k):
        assert not np.isfinite(vals[i])


def test_min_match_plan_routes_to_scan():
    """An all-dense min_match disjunction compiles to an int scan_shape
    and its device result equals the oracle (engagement + exactness)."""
    from iresearch_tpu.index.reader import DirectoryReader
    from iresearch_tpu.index.writer import (
        Field, IndexWriter, IndexWriterOptions,
    )
    from iresearch_tpu.search import filters as F
    from iresearch_tpu.search.host_eval import search as search_host
    from iresearch_tpu.store.directory import MemoryDirectory
    from iresearch_tpu.exec import DeviceQuery
    from iresearch_tpu.exec.executor import scan_shape

    rng = np.random.default_rng(29)
    words = [f"w{i:02d}" for i in range(8)]  # tiny vocab -> all dense
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for _ in range(2000):
            n = int(rng.integers(3, 20))
            idx = rng.integers(0, len(words), size=n)
            w.insert([Field("body", " ".join(words[j] for j in idx),
                            analyzer="segmentation")])
        w.commit()
    r = DirectoryReader.open(d)
    flt = F.Or(
        F.ByTerm("body", "w00"), F.ByTerm("body", "w01"),
        F.ByTerm("body", "w02"), F.ByTerm("body", "w03"),
        min_match=3,
    )
    dq = DeviceQuery(flt, list(r.segments))
    shape = scan_shape(dq.plan(0))
    from iresearch_tpu.exec.skyline import skyline_spec

    k = 10
    assert shape == 3 or skyline_spec(dq.plan(0), list(r.segments)[0],
                                      dq.scorer, k) is not None
    vals, docs = dq.execute_segment(0, k)
    oracle = search_host(r, flt, dq.scorer, k=k)
    got = [(int(dd), float(v)) for v, dd in zip(vals, docs)
           if np.isfinite(v)]
    assert len(got) == len(oracle)
    for (gd, gv), (od, ov) in zip(got, oracle):
        assert gv == pytest.approx(ov, rel=1e-5)
