"""Fused scan over dense-grid spans: the speed-of-light term scan.

For a sum tree over dense-grid spans (TermQuery, collapsed OrHighN,
all-dense conjunctions and min_match disjunctions), the fold path
materializes several [nd] f32 intermediates (unpacked freqs, scores,
fold channels, top-k operand). The row-max scan reads ONLY the packed
freq rows and the norms, scores them, and reduces each 128-doc row to
(max score, first argmax lane): the [nd] operands never reach device
memory, XLA fuses the unpack, score and row reduction into one pass.

Top-k then picks the best rows by row max and RE-SCORES just those
rows (128 lanes each, in plain JAX) — exact, including the smaller-doc
tie rule.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax

from iresearch_tpu.formats.bitpack import words_per_block
from iresearch_tpu.formats.spec import BLOCK

def _score_expr(scorer, w, f, dl, avgdl, jnp):
    """Elementwise score of one span on a tile (mirrors score_block)."""
    from iresearch_tpu.search.scorers import BM25, TFIDF, BoostScore

    if isinstance(scorer, BM25):
        kb = scorer.k * scorer.b
        c0 = scorer.k - kb
        denom = f + (c0 + (kb / avgdl) * dl if scorer.b != 0.0 else c0)
        return w * f / jnp.maximum(denom, 1e-9)
    if isinstance(scorer, TFIDF):
        if scorer.with_norms:
            return w * jnp.sqrt(f) * jax.lax.rsqrt(jnp.maximum(dl, 1.0))
        return w * jnp.sqrt(f)
    if isinstance(scorer, BoostScore):
        return jnp.where(f > 0, w, 0.0)
    raise NotImplementedError(type(scorer))


@functools.partial(
    jax.jit, static_argnames=("scorer", "span_bits", "conj", "mm")
)
def dense_scan_rowmax_xla(
    span_words, span_w, norms, avgdl, *, scorer, span_bits, conj=False,
    mm=1,
):
    """(row_max f32 [ndrows], row_arg i32 [ndrows]) of the summed span
    scores; rows with no hit get -inf. XLA fuses the unpack + score +
    row reduction into one pass with no materialized [nd] operands
    surviving to device memory (reductions fuse into their producers)."""
    import jax.numpy as jnp

    from iresearch_tpu.formats.bitpack import unpack_jnp

    ndrows = norms.shape[0]
    if not jnp.issubdtype(norms.dtype, jnp.floating):
        # u16 doc lengths: exact integer convert (via i32 — no u16->f32)
        norms = norms.astype(jnp.int32).astype(jnp.float32)
    score = jnp.zeros((ndrows, BLOCK), jnp.float32)
    # disjunction: hit when any span has f > 0; conjunction: all spans;
    # min_match (mm >= 2): at least mm spans (the fused analog of the
    # reference's min-match early pruning, disjunction.hpp:860-1100)
    fagg = None
    for s, words in enumerate(span_words):
        f = unpack_jnp(words, span_bits[s]).astype(jnp.int32).astype(
            jnp.float32
        )
        score = score + _score_expr(
            scorer, span_w[s], f, norms, avgdl, jnp
        )
        h = (f > 0.0).astype(jnp.float32) if mm > 1 else f
        fagg = h if fagg is None else (
            jnp.minimum(fagg, h) if conj else fagg + h
        )
    hit = fagg >= float(mm) if mm > 1 else fagg > 0.0
    masked = jnp.where(hit, score, -jnp.inf)
    amax = jnp.max(masked, axis=1)
    lane_i = jnp.arange(BLOCK, dtype=jnp.int32)
    first = jnp.min(
        jnp.where(masked == amax[:, None], lane_i[None, :], BLOCK), axis=1
    ).astype(jnp.int32)
    return amax, jnp.minimum(first, BLOCK - 1)


def _score_rows(
    span_words, span_w, span_bits, norms_rows, avgdl, rows, scorer,
    conj=False, mm=1,
):
    """Re-score M gathered rows in plain JAX: [M, 128] masked scores."""
    import jax.numpy as jnp

    m = rows.shape[0]
    if not jnp.issubdtype(norms_rows.dtype, jnp.floating):
        norms_rows = norms_rows.astype(jnp.int32).astype(jnp.float32)
    score = jnp.zeros((m, BLOCK), jnp.float32)
    fagg = None
    lane = jnp.arange(BLOCK, dtype=jnp.uint32)
    for s, words in enumerate(span_words):
        b = span_bits[s]
        g = 32 // b
        wpb = words_per_block(b)
        mask = jnp.uint32(0xFFFFFFFF if b == 32 else (1 << b) - 1)
        w_rows = words[rows]  # [M, wpb] gather
        rep = jnp.tile(w_rows, (1, g))  # [M, 128]
        shift = (lane // jnp.uint32(wpb)) * jnp.uint32(b)
        f = ((rep >> shift[None, :]) & mask).astype(jnp.int32).astype(
            jnp.float32
        )
        score = score + _score_expr(
            scorer, span_w[s], f, norms_rows, avgdl, jnp
        )
        h = (f > 0.0).astype(jnp.float32) if mm > 1 else f
        fagg = h if fagg is None else (
            jnp.minimum(fagg, h) if conj else fagg + h
        )
    hit = fagg >= float(mm) if mm > 1 else fagg > 0.0
    return jnp.where(hit, score, -jnp.inf)


@functools.partial(
    jax.jit,
    static_argnames=(
        "scorer", "span_bits", "k", "conj", "mm",
    ),
)
def dense_scan_topk(
    span_words,
    span_w,
    norms,  # f32 [ndrows, 128]
    avgdl,
    *,
    scorer,
    span_bits: Tuple[int, ...],
    k: int,
    conj: bool = False,
    mm: int = 1,
):
    """Exact (vals f32 [k], docs i32 [k]) for a sum tree of dense spans
    — disjunctive (any span hits), conjunctive (all spans hit), or
    min_match (>= mm spans hit) — ordered by (-score, doc); -inf when
    matches < k.

    Refine step: the top 2k rows by row max provably contain every
    winner — at most k rows hold scores strictly above the true k-th
    (each such row contributes >=1 doc above it), and tied winners take
    the smallest doc ids, i.e. the EARLIEST tied rows, of which at most
    k are needed; ``wide_top_k``'s (value desc, row asc) order lists
    both groups inside the first 2k rows."""
    import jax.numpy as jnp

    from iresearch_tpu.ops.topk import wide_top_k

    bv, _bi = dense_scan_rowmax_xla(
        span_words, span_w, norms, avgdl,
        scorer=scorer, span_bits=span_bits, conj=conj, mm=mm,
    )
    ndrows = norms.shape[0]
    m = min(max(2 * k, 16), ndrows)
    _rv, rows = wide_top_k(bv, m)
    rows = rows.astype(jnp.int32)
    scores = _score_rows(
        span_words, span_w, span_bits, norms[rows], avgdl, rows, scorer,
        conj=conj, mm=mm,
    )  # [M, 128]
    docs = rows[:, None] * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)[None, :]
    from iresearch_tpu.exec.candidates import topk_docs

    return topk_docs(scores.reshape(-1), docs.reshape(-1), k)
