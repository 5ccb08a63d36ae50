"""Batched query execution — many queries per device dispatch.

The reference achieves query throughput with thread-per-query pull
iterators (utils/index-search.cpp:718). The device replacement batches
queries into dense device work (SURVEY.md §2.11 item 2): queries whose
plans share a signature (same boolean tree shape, same (field, width-
class) group keys) are stacked along a leading query axis and executed by
ONE jitted vmapped program — decode/score/scatter/fold/top-k for the whole
batch in a single dispatch, amortizing host-device latency and letting XLA
keep the MXU/VPU busy across queries.
"""

from __future__ import annotations

from collections import defaultdict
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import numpy as np

from iresearch_tpu.exec.executor import (
    _NEG_INF,
    _USE_SKYLINE,
    DeviceQuery,
    segment_body,
    wand_body,
)
from iresearch_tpu.formats.bitpack import BITS
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.scorers import BM25, Scorer


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# per-dispatch live-lane budget: a vmapped batch materializes
# Q x width lanes of intermediates (~24 B each); at 5M docs an 80-query
# vmap would hold >10 GB of them. Chunking trades pure vmap parallelism
# for bounded peak memory: lax.map over sub-batches of `chunk` queries,
# still ONE dispatch. 2^25 lanes ~= 0.8 GB live, a small share of an
# 80 GB card, which leaves the rest to the index and its grid caches.
_BATCH_LANE_BUDGET = int(
    __import__("os").environ.get("IRS_BATCH_LANE_BUDGET", str(1 << 25))
)


def _chunked_vmap(one, xs, q: int, width: int):
    """vmap(one)(xs) when it fits; otherwise lax.map of chunk-wide vmaps.

    ``one`` takes the xs pytree sliced to one query and returns a pytree
    of per-query outputs (small: top-k sized). Chunk padding repeats the
    last query; padded outputs are dropped."""
    import jax.numpy as jnp
    from jax import lax, tree_util

    chunk = max(1, min(q, _BATCH_LANE_BUDGET // max(1, width)))
    if chunk >= q:
        return jax.vmap(one)(xs)
    from iresearch_tpu.utils.metrics import registry

    registry().counter(
        "irs_batch_chunked",
        help_="batch dispatches split by the lane budget "
        "(IRS_BATCH_LANE_BUDGET; counted at trace time)",
    )
    nq = -(-q // chunk)
    pad = nq * chunk - q
    if pad:
        xs = tree_util.tree_map(
            lambda a: jnp.concatenate(
                [a, jnp.repeat(a[-1:], pad, axis=0)], axis=0
            ),
            xs,
        )
    xs_c = tree_util.tree_map(
        lambda a: a.reshape((nq, chunk) + a.shape[1:]), xs
    )
    out = lax.map(lambda x: jax.vmap(one)(x), xs_c)
    return tree_util.tree_map(
        lambda a: a.reshape((nq * chunk,) + a.shape[2:])[:q], out
    )


def _stack_dense_dyn(dense_dyn):
    """WAND upper bounds may arrive as a tuple of Q per-plan device
    arrays [ndrows] (uploaded once per cached plan, see _dense_ub_dev) —
    stack to [Q, ndrows] in-trace (a device-side concat) so the vmapped
    bodies see one array per span. No-op for spans without the tuple."""
    import jax.numpy as jnp

    return tuple(
        dd[:2] + (jnp.stack(dd[2]),) + dd[3:]
        if len(dd) > 2 and isinstance(dd[2], tuple)
        else dd
        for dd in dense_dyn
    )


def _joint_pad(ctxs, qis, sig):
    """Cross-segment padding needs for one joint group.

    ctxs: the (plans, sky_specs, sigs) of every segment whose per-segment
    signature equals ``sig``; qis: the group's query indices.  Returns
    (pad_rows, pad_aux) — pow2 row counts per posting group and pow2 aux
    match counts per aux leaf, maxed over segments and queries — so each
    of those segments stacks to identical shapes and their fused programs
    share one compiled executable."""
    gkeys, A, sky = sig[2], sig[3], sig[10]
    pad_rows = pad_aux = None
    if sky is None and gkeys:
        pad_rows = tuple(
            _pow2(
                max(
                    len(c[0][qi].groups[gi].rows_d)
                    for c in ctxs
                    for qi in qis
                )
            )
            for gi in range(len(gkeys))
        )
    if sky is None and A:
        pad_aux = tuple(
            _pow2(
                max(
                    8,
                    max(
                        len(c[0][qi].aux_pairs[a][0])
                        for c in ctxs
                        for qi in qis
                    ),
                )
            )
            for a in range(A)
        )
    return (pad_rows, pad_aux)


def _bucket4(n: int) -> int:
    """Row-count bucket at 4x granularity: queries within one bucket batch
    into one dispatch (row padding <=4x, dwarfed by per-dispatch cost),
    while a LowTerm query never inflates to a HighTerm query's rows."""
    b = 8
    while b < n:
        b <<= 2
    return b


@partial(
    jax.jit,
    static_argnames=(
        "tree", "gbits", "scorer", "num_leaves", "k", "nd", "has_aux",
        "dense_static", "use_scan", "scan_conj", "scan_mm",
    ),
)
def _run_batch(
    pools,  # tuple per group: (doc_words, freq_words, base, norms) — shared
    rowsets_b,  # tuple per group: (rows_d [Q,R], rows_f [Q,R], w [Q,R], leaf [Q,R])
    avgdl,  # f32 [G]
    leaf_min_b,  # i32 [Q, L] (min_match can differ per query in a batch)
    aux_sp_b,  # tuple per aux: (docs i32 [Q,Mp] IMAX-padded, vals f32 [Q,Mp]) or None
    _aux_unused,  # kept for arg-structure compatibility (always None)
    alive,  # bool [nd] — shared
    dense_shared=(),  # per dense span: (pool, norms, avgdl) — shared
    dense_dyn=(),  # per dense span: (start [Q], w [Q]) — per query
    *,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    k: int,
    nd: int,
    has_aux: bool,
    dense_static=(),
    use_scan: bool = False,
    scan_conj: bool = False,
    scan_mm: int = 1,
):
    import jax.numpy as jnp
    from jax import lax

    from iresearch_tpu.formats.spec import BLOCK as BLOCK_LANES
    from iresearch_tpu.ops.topk import wide_top_k

    dense_dyn = _stack_dense_dyn(dense_dyn)
    if use_scan:
        # fused row-max scan (ops/dense_scan.py): single-leaf sum trees
        # whose spans are all grid-resident skip the [nd] fold entirely.
        # Split into (1) a vmapped rowmax + row-selection pass and (2) a
        # FLAT-gather exact rescore over all queries' survivor rows at
        # once — 2-D [Q, m] gathers inside the vmap lower to ~8 ns/elem
        # scalar gathers, the flat [Q*m] 1-D row gather to ~0.1-0.5
        # (same restructuring as the batched skyline/dslice tiers)
        from iresearch_tpu.formats.bitpack import unpack_jnp
        from iresearch_tpu.ops.dense_scan import (
            _score_expr,
            dense_scan_rowmax_xla,
        )
        from iresearch_tpu.exec.candidates import topk_docs

        ndrows = dense_static[0][2]
        norms_g = dense_shared[0][3].reshape(ndrows, BLOCK_LANES)
        avgdl_s = dense_shared[0][2]
        span_bits = tuple(d[0] for d in dense_static)
        S = len(dense_static)
        q = leaf_min_b.shape[0]
        m = min(max(2 * k, 16), ndrows)

        def one_rowmax(ddyn):
            words = tuple(
                lax.dynamic_slice(
                    sh[0], (dd[0], jnp.int32(0)), (ndrows, sh[0].shape[1])
                )
                for sh, dd in zip(dense_shared, ddyn)
            )
            bv, _bi = dense_scan_rowmax_xla(
                words,
                tuple(dd[1] for dd in ddyn),
                norms_g,
                avgdl_s,
                scorer=scorer,
                span_bits=span_bits,
                conj=scan_conj,
                mm=scan_mm,
            )
            # the top 2k rows by row max provably contain every winner
            # (see ops/dense_scan.py:dense_scan_topk docstring)
            _rv, rows = wide_top_k(bv, m)
            return rows.astype(jnp.int32)

        # the rowmax keeps no [nd] operand live (fused reduction), only
        # the sliced packed rows (~nd/4 lanes of u32 at 8 bits) per span
        width = (nd // 4) * max(1, len(dense_static))
        rows_b = _chunked_vmap(one_rowmax, dense_dyn, q, width)  # [Q, m]

        starts_b2 = jnp.stack([dd[0] for dd in dense_dyn], axis=1)
        ws_b2 = jnp.stack([dd[1] for dd in dense_dyn], axis=1)

        def rescore(rows_c, starts_c, ws_c):
            """Flat-gather exact rescore of each query's survivor rows.

            Scores through the SAME expression (_score_expr) as the
            row-selection pass and the single-query _score_rows, so the
            selection metric and final score agree bit-for-bit; doc ids
            are real (row*128+lane) even for non-matching -inf lanes —
            identical conventions to dense_scan_topk."""
            qc = rows_c.shape[0]
            dl = norms_g[rows_c.reshape(-1)].reshape(qc, m, BLOCK_LANES)
            if not jnp.issubdtype(dl.dtype, jnp.floating):
                dl = dl.astype(jnp.int32).astype(jnp.float32)
            score = jnp.zeros((qc, m, BLOCK_LANES), jnp.float32)
            fagg = None
            for s in range(S):
                rows_abs = (starts_c[:, s : s + 1] + rows_c).reshape(-1)
                f = unpack_jnp(
                    dense_shared[s][0][rows_abs], span_bits[s]
                ).reshape(qc, m, BLOCK_LANES).astype(jnp.int32).astype(
                    jnp.float32
                )
                score = score + _score_expr(
                    scorer, ws_c[:, s, None, None], f, dl, avgdl_s, jnp
                )
                h = (f > 0.0).astype(jnp.float32) if scan_mm > 1 else f
                fagg = h if fagg is None else (
                    jnp.minimum(fagg, h) if scan_conj else fagg + h
                )
            lane = jnp.arange(BLOCK_LANES, dtype=jnp.int32)
            docs = (
                rows_c[:, :, None] * BLOCK_LANES + lane[None, None, :]
            )
            hit = fagg >= float(scan_mm) if scan_mm > 1 else fagg > 0.0
            masked = jnp.where(hit, score, _NEG_INF)
            return jax.vmap(lambda v, d: topk_docs(v, d, k))(
                masked.reshape(qc, -1), docs.reshape(qc, -1)
            )

        # the rescore materializes ~4 [chunk, m, 128] f32 operands —
        # chunk it by the lane budget like the rowmax stage
        chunk = max(1, min(q, _BATCH_LANE_BUDGET // max(1, m * 128 * 4)))
        if chunk >= q:
            return rescore(rows_b, starts_b2, ws_b2)
        nq = -(-q // chunk)
        pad = nq * chunk - q
        if pad:
            rows_b, starts_b2, ws_b2 = (
                jnp.concatenate(
                    [a, jnp.repeat(a[-1:], pad, axis=0)], axis=0
                )
                for a in (rows_b, starts_b2, ws_b2)
            )
        out = lax.map(
            lambda xs: rescore(*xs),
            (
                rows_b.reshape(nq, chunk, m),
                starts_b2.reshape(nq, chunk, -1),
                ws_b2.reshape(nq, chunk, -1),
            ),
        )
        return tuple(
            a.reshape((nq * chunk,) + a.shape[2:])[:q] for a in out
        )

    def one(xs):
        rowsets, leaf_min, aux_sp, ddyn = xs
        dense_args = tuple(
            (sh[0], dd[0], dd[1], sh[1], sh[2])
            for sh, dd in zip(dense_shared, ddyn)
        )
        aux_m = aux_s = None
        if aux_sp is not None:
            # densify the sparse (docs, vals) aux upload on device —
            # the host never ships [A, nd] arrays (VERDICT r2 item 6)
            A = len(aux_sp)
            aux_m = jnp.zeros((A, nd), jnp.bool_)
            aux_s = jnp.zeros((A, nd), jnp.float32)
            for a, (docs_a, vals_a) in enumerate(aux_sp):
                aux_m = aux_m.at[a, docs_a].set(True, mode="drop")
                aux_s = aux_s.at[a, docs_a].set(vals_a, mode="drop")
        match, score = segment_body(
            pools,
            rowsets,
            avgdl,
            leaf_min,
            aux_m,
            aux_s,
            alive,
            tree=tree,
            gbits=gbits,
            scorer=scorer,
            num_leaves=num_leaves,
            nd=nd,
            dense_args=dense_args,
            dense_static=dense_static,
        )
        # top-k inside the per-query body: the chunked map then only
        # keeps [chunk, nd] intermediates live, never [Q, nd]
        return wide_top_k(jnp.where(match, score, _NEG_INF), k)

    q = leaf_min_b.shape[0]
    xs = (
        rowsets_b,
        leaf_min_b,
        aux_sp_b if has_aux else None,
        dense_dyn,
    )
    width = nd * (max(1, num_leaves) + (len(aux_sp_b or ()) if has_aux else 0))
    vals, docs = _chunked_vmap(one, xs, q, width)
    return vals, docs  # [Q, k]


@partial(
    jax.jit,
    static_argnames=(
        "tree", "gbits", "scorer", "num_leaves", "k", "mode",
        "driver_gi", "group_leaf", "wand", "sample", "wand_mode", "nd",
        "dense_static",
    ),
)
def _run_batch_candidates(
    pools,  # shared per group
    rowsets_b,  # per group: row arrays stacked [Q, R]
    avgdl,  # f32 [G]
    leaf_min_b,  # i32 [Q, L]
    alive,  # bool [nd]
    nreal_b,  # i32 [Q, G]
    dense_shared=(),  # per dense span: (pool, norms, avgdl) — shared
    dense_dyn=(),  # per dense span: (start [Q], w [Q]) — per query
    *,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    k: int,
    mode: str,
    driver_gi: int,
    group_leaf: tuple,
    wand: bool,
    sample: int,
    wand_mode: str = "exact",
    nd: int = 0,
    dense_static=(),
):
    """Vmapped scale-proportional tiers (exec/candidates.py): per-batch
    work ∝ Q × postings, independent of corpus size."""
    from iresearch_tpu.exec.candidates import candidate_body

    dense_dyn = _stack_dense_dyn(dense_dyn)

    def one(xs):
        rowsets, leaf_min, nreal, ddyn = xs
        dense_args = tuple(
            (sh[0], dd[0], dd[1], sh[1], sh[2])
            for sh, dd in zip(dense_shared, ddyn)
        )
        return candidate_body(
            pools,
            rowsets,
            avgdl,
            leaf_min,
            alive,
            nreal,
            tree=tree,
            gbits=gbits,
            scorer=scorer,
            num_leaves=num_leaves,
            k=k,
            mode=mode,
            driver_gi=driver_gi,
            group_leaf=group_leaf,
            wand=wand,
            sample=sample,
            wand_mode=wand_mode,
            nd=nd,
            dense_args=dense_args,
            dense_static=dense_static,
        )

    q = leaf_min_b.shape[0]
    # per-query live width in ~24B lane units: sort carries ~6 operands
    # per decoded lane; join probes are single-word gathers per candidate
    # (plus [P,128] blocks for sparse probed spans); gridmix streams the
    # grid per dense span
    lanes = sum(rs[0].shape[-1] * 128 for rs in rowsets_b)
    if mode == "join":
        pd = rowsets_b[driver_gi][0].shape[-1] * 128
        width = pd * (4 + 64 * max(0, len(rowsets_b) - 1))
    elif mode == "gridmix":
        width = nd * max(1, num_leaves) + lanes * 6
    else:
        width = lanes * (6 if mode == "sort" else 2)
    return _chunked_vmap(
        one, (rowsets_b, leaf_min_b, nreal_b, dense_dyn), q, width
    )


@partial(jax.jit, static_argnames=("gbits", "scorer", "k", "R"))
def _run_batch_dslice(
    pool,  # (doc_words, freq_words, nrm_words, base, norms) — shared
    starts_b,  # i32 [Q, 3] (dstart, fstart, nstart)
    nreal_b,  # i32 [Q] real row counts
    w_b,  # f32 [Q] term weights
    avgdl,  # f32 [1]
    alive,  # bool [nd] or None
    *,
    gbits,  # (bd, bf, bn) — static
    scorer: Scorer,
    k: int,
    R: int,
):
    """Batched contiguous-slice single-term top-k.

    All queries' [R, wpb] row windows are fetched with ONE flat row-index
    gather per pool (a [Q*R] 1-D index keeps XLA on the fast row-copy
    lowering; vmapping the dynamic_slices — or a 2-D [Q, R] index —
    lowers to per-element gathers instead). The decode +
    score + top-k then vmaps over the pre-gathered rows."""
    import jax.numpy as jnp

    from iresearch_tpu.exec.candidates import dslice_core
    from iresearch_tpu.formats.bitpack import words_per_block

    bd, bf, bn = gbits
    doc_words, freq_words, nrm_words, base, norms = pool
    q = nreal_b.shape[0]
    ar = jnp.arange(R, dtype=jnp.int32)

    def rows_of(pp, st, wpb):
        idx = (st[:, None] + ar[None, :]).reshape(-1)
        return pp[idx].reshape(q, R, wpb)

    dwords_b = rows_of(doc_words, starts_b[:, 0], words_per_block(bd))
    fwords_b = rows_of(freq_words, starts_b[:, 1], words_per_block(bf))
    nwords_b = (
        rows_of(nrm_words, starts_b[:, 2], words_per_block(bn))
        if bn >= 0
        else None
    )
    base_b = base[(starts_b[:, 0][:, None] + ar[None, :]).reshape(-1)].reshape(
        q, R
    )

    def one(xs):
        dw, fw, nw, br, nrl, w = xs
        return dslice_core(
            dw, fw, nw, br, norms, nrl, w, avgdl[0], alive,
            gbits=gbits, scorer=scorer, k=k, R=R,
        )

    return _chunked_vmap(
        one,
        (dwords_b, fwords_b, nwords_b, base_b, nreal_b, w_b),
        q,
        R * 128 * 6,
    )


@partial(
    jax.jit,
    static_argnames=("scorer", "span_bits", "k", "ndrows", "conj", "mm"),
)
def _run_batch_skyline(
    span_pools,  # per span: u32 dense pool (shared across queries)
    norms_grid,  # [ndrows, 128] doc lengths (shared)
    rows_b,  # i32 [Q, M] survivor rows, IMAX-padded
    starts_b,  # i32 [Q, S]
    ws_b,  # f32 [Q, S]
    avgdl,  # f32 [1]
    *,
    scorer: Scorer,
    span_bits,
    k: int,
    ndrows: int,
    conj: bool = False,
    mm: int = 1,
):
    """Batched survivor-row skyline top-k (exec/skyline.py): each query
    gathers only its θ-surviving grid rows instead of scanning the whole
    [ndrows] grid — the batched analog of wanderator block skipping.

    Row gathers run once for the whole batch with flat 1-D indices (the
    fast row-copy lowering — see skyline_topk_batch); the lane budget
    chunks over queries when Q*M grows past it."""
    import jax.numpy as jnp
    from jax import lax

    from iresearch_tpu.exec.skyline import skyline_topk_batch

    q = starts_b.shape[0]
    M = rows_b.shape[1]

    def run(rows_c, starts_c, ws_c):
        return skyline_topk_batch(
            span_pools,
            norms_grid,
            rows_c,
            starts_c,
            ws_c,
            avgdl[0],
            scorer=scorer,
            span_bits=span_bits,
            k=k,
            ndrows=ndrows,
            conj=conj,
            mm=mm,
        )

    # [chunk, M, 128] f32 intermediates x ~4 operands
    chunk = max(1, min(q, _BATCH_LANE_BUDGET // max(1, M * 128 * 4)))
    if chunk >= q:
        return run(rows_b, starts_b, ws_b)
    nq = -(-q // chunk)
    pad = nq * chunk - q
    if pad:
        rows_b, starts_b, ws_b = (
            jnp.concatenate([a, jnp.repeat(a[-1:], pad, axis=0)], axis=0)
            for a in (rows_b, starts_b, ws_b)
        )
    out = lax.map(
        lambda xs: run(*xs),
        (
            rows_b.reshape(nq, chunk, M),
            starts_b.reshape(nq, chunk, -1),
            ws_b.reshape(nq, chunk, -1),
        ),
    )
    return tuple(
        a.reshape((nq * chunk,) + a.shape[2:])[:q] for a in out
    )


@partial(
    jax.jit,
    static_argnames=(
        "tree", "gbits", "scorer", "num_leaves", "k", "nd", "sample",
        "wand_mode", "dense_static",
    ),
)
def _run_batch_wand(
    pools,  # shared per group
    rowsets_b,  # per group: (rows_d, rows_f, w, leaf, ub, other) each [Q, R]
    avgdl,  # f32 [G]
    leaf_min_b,  # i32 [Q, L]
    alive,  # bool [nd]
    dense_shared=(),  # per dense span: (pool, norms, avgdl) — shared
    dense_dyn=(),  # per dense span: (start [Q], w [Q], ub [Q,ndrows], other [Q])
    *,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    k: int,
    nd: int,
    sample: int,
    wand_mode: str = "exact",
    dense_static=(),
):
    """Vmapped block-max WAND: per-query θ and pruning in one dispatch."""

    dense_dyn = _stack_dense_dyn(dense_dyn)

    def one(xs):
        rowsets, leaf_min, ddyn = xs
        dense_args = tuple(
            (sh[0], dd[0], dd[1], sh[1], sh[2], dd[2], dd[3])
            for sh, dd in zip(dense_shared, ddyn)
        )
        return wand_body(
            pools,
            rowsets,
            avgdl,
            leaf_min,
            alive,
            tree=tree,
            gbits=gbits,
            scorer=scorer,
            num_leaves=num_leaves,
            k=k,
            nd=nd,
            sample=sample,
            mode=wand_mode,
            dense_args=dense_args,
            dense_static=dense_static,
        )

    q = leaf_min_b.shape[0]
    return _chunked_vmap(
        one,
        (rowsets_b, leaf_min_b, dense_dyn),
        q,
        nd * max(1, num_leaves) * 2,  # two fold passes live per query
    )


class QueryBatch:
    """Executes many prepared queries per segment in few dispatches.

    Queries are grouped by plan signature; each group becomes one stacked
    vmapped call. Results are exact per-query top-k, identical to
    DeviceQuery.execute_segment.
    """

    def __init__(
        self,
        filters: Sequence[F.Filter],
        segments: Sequence,
        scorer: Optional[Scorer] = None,
        wand: bool = False,
        wand_sample: int = 16,
        wand_mode: str = "exact",
    ) -> None:
        self.scorer = scorer or BM25()
        self.segments = list(segments)
        self.wand_sample = wand_sample
        self.wand_mode = wand_mode
        # device_phrase off: batch stacking materializes aux arrays host-side
        self.queries = [
            DeviceQuery(
                f, self.segments, self.scorer, wand=wand,
                wand_mode=wand_mode, device_phrase=False,
            )
            for f in filters
        ]

    def execute_segment(
        self, seg_idx: int, k: int
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per-query (scores [k], local docs [k]) for one segment."""
        raw = self.prepare(seg_idx, k).run()
        return [(np.asarray(v), np.asarray(d)) for v, d in raw]

    def search(self, k: int) -> List[List[Tuple[int, float]]]:
        """Global top-k per query over all segments: one batched dispatch
        set per segment, host merge of (global_doc, score) candidates
        ordered by (-score, doc)."""
        per_seg = [self.execute_segment(s, k) for s in range(len(self.segments))]
        base = np.zeros(len(self.segments) + 1, np.int64)
        np.cumsum([sr.num_docs for sr in self.segments], out=base[1:])
        out: List[List[Tuple[int, float]]] = []
        for qi in range(len(self.queries)):
            cands: List[Tuple[int, float]] = []
            for s, res in enumerate(per_seg):
                vals, docs = res[qi]
                for v, d in zip(vals, docs):
                    if np.isfinite(v):
                        cands.append((int(base[s] + d), float(v)))
            cands.sort(key=lambda t: (-t[1], t[0]))
            out.append(cands[:k])
        return out

    def prepare_all(self, k: int):
        """Prepared GLOBAL batch over every segment: run() dispatches
        each segment's fused program plus one device merge and returns
        global (vals [Q,k], docs [Q,k]) — see exec/segmerge.py.

        Queries are grouped by a JOINT cross-segment signature and padded
        to the cross-segment maximum, so segments whose per-segment
        signatures (and pow2-padded pool shapes) coincide — the common
        case for equal-size segments of one corpus — produce IDENTICAL
        fused programs: one compiled executable serves every segment
        instead of one per segment.  This bounds the compiled-program
        set of a multi-segment index (reference executes per segment
        with shared prepared state, index-search.cpp:714-780; here the
        sharing extends to the compiled artifact itself)."""
        from iresearch_tpu.exec.segmerge import MergedBatch

        nseg = len(self.segments)
        if nseg > 1:
            ctxs = [self._plans_and_sigs(si, k) for si in range(nseg)]
            # skyline stacks pad within their 4x row bucket only
            # (ADVICE r4 item 3): when one query's per-segment buckets
            # differ, lift every segment to the cross-segment max so
            # same-class skyline groups share one compiled executable
            # (remaining diversity — per-segment pow2 POOL shapes — is
            # inherent to unequal segments and documented below)
            for qi in range(len(self.queries)):
                svals = [c[2][qi][10] for c in ctxs]
                if (
                    all(sv is not None for sv in svals)
                    and len({sv[0] for sv in svals}) == 1
                    and len({sv[1] for sv in svals}) > 1
                ):
                    mx = max(sv[1] for sv in svals)
                    for c in ctxs:
                        sig = c[2][qi]
                        c[2][qi] = sig[:10] + ((sig[10][0], mx),)
            joint: Dict[tuple, List[int]] = defaultdict(list)
            for qi in range(len(self.queries)):
                joint[tuple(c[2][qi] for c in ctxs)].append(qi)
            per_seg = []
            for s in range(nseg):
                gl = []
                for jsig, qis in joint.items():
                    sig_s = jsig[s]
                    # pad to the max need over segments SHARING this
                    # per-segment signature (equal sigs => compatible
                    # group structure => elementwise max is well-typed)
                    same = [
                        s2 for s2 in range(nseg) if jsig[s2] == sig_s
                    ]
                    pad = _joint_pad(
                        [ctxs[s2] for s2 in same], qis, sig_s
                    )
                    gl.append((sig_s, qis, pad))
                per_seg.append(gl)
            preps = [
                self.prepare(si, k, _groups=per_seg[si], _ctx=ctxs[si])
                for si in range(nseg)
            ]
        else:
            preps = [self.prepare(si, k) for si in range(nseg)]
        return MergedBatch(
            preps, [sr.num_docs for sr in self.segments], k
        )

    def _plans_and_sigs(self, seg_idx: int, k: int):
        """(plans, sky_specs, sigs): per-query plan + stacking signature
        for one segment — the grouping key of prepare()."""
        plans = [q.plan_for_k(seg_idx, k) for q in self.queries]
        sr = self.segments[seg_idx]

        # skyline specs computed up front: eligibility is per QUERY (the θ
        # cut and cost gate depend on the term), so a signature group must
        # split by skyline bucket — one ineligible query must not drag its
        # whole category to the full scan
        from iresearch_tpu.exec import skyline as _sky

        sky_specs: Dict[int, object] = {}
        for qi, p in enumerate(plans):
            sp = None
            if (
                _USE_SKYLINE
                and p.exec_mode == "dense"
                and not p.groups
            ):
                kk = min(k, p.nd_pad)
                skey = ("skyspec", kk)
                if skey in p.cache:  # shared via the prepared-plan cache
                    sp = p.cache[skey]
                else:
                    sp = _sky.skyline_spec(p, sr, self.scorer, kk)
                    p.cache[skey] = sp
            sky_specs[qi] = sp

        sigs = []
        for qi, p in enumerate(plans):
            sp = sky_specs[qi]
            sig = (
                p.tree,
                p.num_leaves,
                tuple((g.field_name, g.dcls, g.fcls, g.ncls) for g in p.groups),
                0 if p.aux_pairs is None else len(p.aux_pairs),
                (bool(p.groups) and p.groups[0].ub is not None)
                or any(d.ub is not None for d in p.dense_spans),
                p.exec_mode,
                p.driver_gi,
                p.driver_leaf,
                # bucketed row counts join the signature (see _bucket4)
                tuple(_bucket4(len(g.rows_d)) for g in p.groups),
                # dense-grid spans: shared pool identity + leaf wiring
                tuple(
                    (d.field_name, d.cls, d.leaf, d.ndrows)
                    for d in p.dense_spans
                ),
                # skyline (classes, row-budget bucket at 4x granularity —
                # pow2 buckets fragmented an 80-query OrHighN category
                # into ~7 single-query dispatch groups; padded rows are
                # IMAX-redirected and cost ~0.1 us each); None = scan/fold
                None
                if sp is None
                else (sp.classes, _bucket4(len(sp.row_ids))),
            )
            sigs.append(sig)
        return plans, sky_specs, sigs

    def prepare(
        self, seg_idx: int, k: int, _groups=None, _ctx=None
    ) -> "PreparedBatch":
        """Stack plans into device arrays once; re-runnable cheaply.

        ``_groups``/``_ctx`` (internal, from prepare_all): precomputed
        [(sig, qis, pad)] joint grouping + this segment's plan context —
        pads row/aux stacks to the cross-segment max so same-signature
        segments compile to one shared executable."""
        import jax.numpy as jnp

        if _ctx is not None:
            plans, sky_specs, _sigs = _ctx
        else:
            plans, sky_specs, _sigs = self._plans_and_sigs(seg_idx, k)
        sr = self.segments[seg_idx]

        if _groups is not None:
            grouped = _groups
        else:
            groups_by_sig: Dict[tuple, List[int]] = defaultdict(list)
            for qi, sig in enumerate(_sigs):
                groups_by_sig[sig].append(qi)
            grouped = [
                (sig, qis, None) for sig, qis in groups_by_sig.items()
            ]

        calls = []
        for sig, qis, pad in grouped:
            tree, num_leaves, gkeys, A, use_wand, exec_mode, driver_gi, \
                driver_leaf, _buckets, dkeys, sky_M = sig
            pad_rows, pad_aux = pad if pad is not None else (None, None)
            reps = [plans[qi] for qi in qis]
            Q = len(qis)
            nd = reps[0].nd_pad
            if sky_M is not None:
                # survivor-row skyline kernel: each query ships only its
                # θ-surviving row ids (exec/skyline.py)
                specs = [sky_specs[qi] for qi in qis]
                s0 = specs[0]
                _classes, M = sky_M
                dfield = sr.device_field(s0.field_name)
                cache = sr.dense_cache(s0.field_name)
                rows_b = np.full((Q, M), 2**31 - 1, np.int32)
                for j, sp in enumerate(specs):
                    rows_b[j, : len(sp.row_ids)] = sp.row_ids
                args = (
                    tuple(
                        dfield.dense_words(cache, c) for c in s0.classes
                    ),
                    dfield.norms_grid(),
                    rows_b,
                    np.asarray([sp.starts for sp in specs], np.int32),
                    np.asarray([sp.ws for sp in specs], np.float32),
                    np.asarray([s0.avgdl], np.float32),
                )
                kwargs = dict(
                    scorer=self.scorer,
                    span_bits=tuple(BITS[c] for c in s0.classes),
                    k=min(k, nd),
                    ndrows=s0.ndrows,
                    conj=s0.conj,
                    mm=s0.min_match,
                )
                calls.append((qis, args, kwargs, _run_batch_skyline))
                continue
            # pad each group to the max row count within this bucket
            # (cross-segment max when prepare_all supplied a joint pad)
            Rs = (
                list(pad_rows)
                if pad_rows is not None
                else [
                    _pow2(max(len(p.groups[gi].rows_d) for p in reps))
                    for gi in range(len(gkeys))
                ]
            )
            if exec_mode == "dslice":
                # single group / single span: ship 3 start rows + count +
                # weight per query instead of [Q, R] row arrays
                fname, dcls, fcls, ncls = gkeys[0]
                dfield = sr.device_field(fname)
                has_nrm = dfield.nrm_words is not None and ncls >= 0
                pool = (
                    dfield.doc_words[dcls],
                    dfield.freq_words[fcls],
                    dfield.nrm_words[ncls] if has_nrm
                    else dfield.freq_words[fcls],
                    dfield.base[dcls],
                    dfield.norms,
                )
                gb = (BITS[dcls], BITS[fcls], BITS[ncls] if has_nrm else -1)
                R = min(
                    Rs[0],
                    pool[0].shape[0], pool[1].shape[0], pool[2].shape[0],
                )
                starts_b = np.stack(
                    [
                        np.asarray(
                            [
                                p.groups[0].rows_d[0],
                                p.groups[0].rows_f[0],
                                p.groups[0].rows_n[0],
                            ],
                            np.int32,
                        )
                        for p in reps
                    ]
                )
                nreal_b = np.asarray(
                    [p.groups[0].real_rows for p in reps], np.int32
                )
                w_b = np.asarray(
                    [p.groups[0].weight[0] for p in reps], np.float32
                )
                args = (
                    pool,
                    starts_b,
                    nreal_b,
                    w_b,
                    np.asarray(reps[0].group_avgdl[:1], np.float32),
                    sr.device().alive if sr.has_deletes else None,
                )
                kwargs = dict(
                    gbits=gb,
                    scorer=self.scorer,
                    k=min(k, nd, R * 128),
                    R=R,
                )
                calls.append((qis, args, kwargs, _run_batch_dslice))
                continue
            pools = []
            rowsets_b = []
            gbits = []
            for gi, (fname, dcls, fcls, ncls) in enumerate(gkeys):
                dfield = sr.device_field(fname)
                has_nrm = dfield.nrm_words is not None and ncls >= 0
                pools.append(
                    (
                        dfield.doc_words[dcls],
                        dfield.freq_words[fcls],
                        dfield.nrm_words[ncls] if has_nrm
                        else dfield.freq_words[fcls],
                        dfield.base[dcls],
                        dfield.norms,
                    )
                )
                gbits.append(
                    (BITS[dcls], BITS[fcls], BITS[ncls] if has_nrm else -1)
                )
                R = Rs[gi]
                rows_d = np.zeros((Q, R), np.int32)
                rows_f = np.zeros((Q, R), np.int32)
                rows_n = np.zeros((Q, R), np.int32)
                w = np.zeros((Q, R), np.float32)
                leaf = np.zeros((Q, R), np.int32)
                ub = np.full((Q, R), -np.inf, np.float32) if use_wand else None
                other = np.zeros((Q, R), np.float32) if use_wand else None
                for j, p in enumerate(reps):
                    g = p.groups[gi]
                    rows_d[j, : len(g.rows_d)] = g.rows_d
                    rows_f[j, : len(g.rows_f)] = g.rows_f
                    rows_n[j, : len(g.rows_n)] = g.rows_n
                    w[j, : len(g.weight)] = g.weight
                    leaf[j, : len(g.leaf)] = g.leaf
                    if use_wand:
                        ub[j, : len(g.ub)] = g.ub
                        other[j, : len(g.other)] = g.other
                # raw numpy: PreparedBatch packs every host array into one
                # per-dtype device upload (see _pack_args)
                rowset = (rows_d, rows_f, rows_n, w, leaf)
                if use_wand:
                    rowset = rowset + (ub, other)
                rowsets_b.append(rowset)
            # dense-grid spans: pool/norms shared; start/w (+ub/other for
            # WAND) stack along the query axis
            dense_shared = []
            dense_dyn = []
            dense_static = []
            # join tier: probed spans reuse the candidate span's decoded
            # dl only when every candidate group is in the span's field
            cand_fields = None
            if exec_mode == "join":
                cand_fields = (
                    {gkeys[driver_gi][0]} if driver_gi >= 0
                    else {g[0] for g in gkeys}
                )
            for di, (fname, cls, leaf, ndrows) in enumerate(dkeys):
                dfield = sr.device_field(fname)
                cache = sr.dense_cache(fname)
                dense_shared.append(
                    (
                        dfield.dense_words(cache, cls),
                        dfield.norms,
                        np.float32(reps[0].dense_spans[di].avgdl),
                        # u16 norms for the fused scan (None -> f32)
                        dfield.norms_u16
                        if dfield.norms_u16 is not None
                        else dfield.norms,
                    )
                )
                starts = np.asarray(
                    [p.dense_spans[di].start for p in reps], np.int32
                )
                ws = np.asarray(
                    [p.dense_spans[di].w for p in reps], np.float32
                )
                if use_wand:
                    # ds.ub is a per-BLOCK [ndrows] array fixed for the
                    # lifetime of a cached plan; upload it ONCE per plan
                    # (plan.cache) and pass the Q device arrays — the
                    # fused program stacks them in-trace. Restacking +
                    # re-uploading [Q, ndrows] f32 per prepare was the
                    # bulk of serving-shaped h2d bytes at 5M docs.
                    ub = tuple(_dense_ub_dev(p, di) for p in reps)
                    other = np.asarray(
                        [p.dense_spans[di].other for p in reps], np.float32
                    )
                    dense_dyn.append((starts, ws, ub, other))
                else:
                    dense_dyn.append((starts, ws))
                same_dl = cand_fields is None or cand_fields == {fname}
                dense_static.append((BITS[cls], leaf, ndrows, same_dl))
            if exec_mode != "dense":
                if exec_mode == "join":
                    lanes = Rs[driver_gi] * 128
                elif exec_mode == "gridmix":
                    lanes = nd
                else:
                    lanes = sum(Rs) * 128
                nreal_b = np.stack(
                    [
                        np.asarray(
                            [g.real_rows * 128 for g in p.groups], np.int32
                        )
                        for p in reps
                    ]
                )
                args = (
                    tuple(pools),
                    tuple(rowsets_b),
                    reps[0].group_avgdl,
                    np.stack([p.leaf_min_match for p in reps]),
                    # skip the per-lane alive gather when nothing is deleted
                    sr.device().alive if sr.has_deletes else None,
                    nreal_b,
                    tuple(dense_shared),
                    tuple(dense_dyn),
                )
                kwargs = dict(
                    tree=tree,
                    gbits=tuple(gbits),
                    scorer=self.scorer,
                    num_leaves=num_leaves,
                    k=min(k, nd, lanes),
                    mode=exec_mode,
                    driver_gi=driver_gi,
                    group_leaf=tuple(
                        int(g.leaf[0]) for g in reps[0].groups
                    ),
                    # θ pruning is useless when the sampled phase would
                    # already decode every row
                    wand=use_wand and max(Rs) > self.wand_sample,
                    sample=self.wand_sample,
                    wand_mode=self.wand_mode,
                    nd=nd,
                    dense_static=tuple(dense_static),
                )
                calls.append((qis, args, kwargs, _run_batch_candidates))
                continue
            if A:
                # sparse aux upload: per aux a pow2 bucket of match docs
                # (IMAX pad) + scores; densified on device in _run_batch
                aux_sp = []
                for a in range(A):
                    pairs_l = [p.aux_pairs[a] for p in reps]
                    Mp = (
                        pad_aux[a]
                        if pad_aux is not None
                        else _pow2(max(8, max(len(d) for d, _ in pairs_l)))
                    )
                    docs_b = np.full((Q, Mp), 2**31 - 1, np.int32)
                    vals_b = np.zeros((Q, Mp), np.float32)
                    for j, (da, va) in enumerate(pairs_l):
                        docs_b[j, : len(da)] = da
                        vals_b[j, : len(da)] = va
                    aux_sp.append((docs_b, vals_b))
                aux_sp = tuple(aux_sp)
            else:
                aux_sp = None
            from iresearch_tpu.exec.executor import scan_shape

            shapes = {scan_shape(p) for p in reps}
            scan_mode = shapes.pop() if len(shapes) == 1 else None
            # no deletes gate: the dense grid zeroes deleted docs at
            # cache build (formats/dense.py)
            use_scan = (
                scan_mode is not None
                and len({f for f, *_ in dkeys}) == 1
            )
            if use_scan:
                args = (
                    tuple(pools),
                    tuple(rowsets_b),
                    reps[0].group_avgdl,
                    np.stack([p.leaf_min_match for p in reps]),
                    None,
                    None,
                    sr.device().alive,
                    tuple(dense_shared),
                    tuple(dense_dyn),
                )
                kwargs = dict(
                    tree=tree,
                    gbits=tuple(gbits),
                    scorer=self.scorer,
                    num_leaves=num_leaves,
                    k=min(k, nd),
                    nd=nd,
                    has_aux=False,
                    dense_static=tuple(dense_static),
                    use_scan=True,
                    scan_conj=scan_mode == "and",
                    scan_mm=scan_mode if isinstance(scan_mode, int) else 1,
                )
                calls.append((qis, args, kwargs, _run_batch))
                continue
            if use_wand:
                args = (
                    tuple(pools),
                    tuple(rowsets_b),
                    reps[0].group_avgdl,
                    np.stack([p.leaf_min_match for p in reps]),
                    sr.device().alive,
                    tuple(dense_shared),
                    tuple(dense_dyn),
                )
                kwargs = dict(
                    tree=tree,
                    gbits=tuple(gbits),
                    scorer=self.scorer,
                    num_leaves=num_leaves,
                    k=min(k, nd),
                    nd=nd,
                    sample=self.wand_sample,
                    wand_mode=self.wand_mode,
                    dense_static=tuple(dense_static),
                )
                calls.append((qis, args, kwargs, _run_batch_wand))
                continue
            args = (
                tuple(pools),
                tuple(rowsets_b),
                reps[0].group_avgdl,
                np.stack([p.leaf_min_match for p in reps]),
                aux_sp,
                None,
                sr.device().alive,
                tuple(dense_shared),
                tuple(dense_dyn),
            )
            kwargs = dict(
                tree=tree,
                gbits=tuple(gbits),
                scorer=self.scorer,
                num_leaves=num_leaves,
                k=min(k, nd),
                nd=nd,
                has_aux=bool(A),
                dense_static=tuple(dense_static),
            )
            calls.append((qis, args, kwargs, _run_batch))
        return PreparedBatch(len(plans), calls)


# global fused-program cache: serving workloads create a fresh
# PreparedBatch per incoming request batch; without this cache every
# request would re-trace + re-compile the fused program (seconds).
# Keyed by the full static structure of the batch — same
# category mix and row buckets => cache hit. LRU-bounded: a long-lived
# server with a drifting query mix must not accumulate programs forever.
from collections import OrderedDict as _OrderedDict

_FUSED_CACHE: "_OrderedDict[tuple, object]" = _OrderedDict()
_FUSED_CACHE_MAX = int(
    __import__("os").environ.get("IRS_FUSED_CACHE_MAX", "256")
)


def clear_fused_cache() -> None:
    """Drop every cached fused batch program (frees XLA executables)."""
    _FUSED_CACHE.clear()


def _dense_ub_dev(p, di):
    """Device-resident copy of plan p's dense span di block upper bounds,
    uploaded once per plan (plan.cache is the sanctioned per-plan device
    cache; the plan itself is never mutated)."""
    import jax.numpy as jnp

    key = ("dense_ub_dev", di)
    dev = p.cache.get(key)
    if dev is None:
        dev = jnp.asarray(p.dense_spans[di].ub)
        p.cache[key] = dev
    return dev


def _pack_args(calls):
    """Replace every HOST numpy array in the calls' args with a slice of
    ONE packed word buffer, uploaded in a single transfer.

    A fresh batch's row/weight/aux arrays are many small host-to-device
    transfers, each with a fixed cost. Packing gets a whole batch on
    device in ONE i32 transfer: f32 data is carried bit-exactly as i32 words and
    bitcast back in-trace; bool/u8 data is padded to word multiples and
    bitcast to u8. Every slice stays 4-byte aligned (an earlier single
    U8 buffer cost the hot redispatch path ~30% because unaligned byte
    slices defeat XLA layouts; word-aligned slices + bitcast fuse for
    free).

    Returns (templates, dev_args, buffers) where templates mirror the
    args pytrees with placeholders: ("dev", i) — device array i;
    ("pk", dtype_key, word_offset, shape, dtype) — bitcast slice of the
    packed word buffer; None stays None.
    """
    import jax.numpy as jnp

    buf: Dict[str, list] = {"w32": []}
    off: Dict[str, int] = {"w32": 0}
    dev_args: list = []
    # dedup device arrays by identity: many signature groups reference the
    # SAME pool arrays, and XLA's hbm budget counts every parameter — at
    # 5M docs duplicated pool params summed to 13.8 GB of "arguments" and
    # failed compile. One parameter per distinct buffer.
    dev_index: Dict[int, int] = {}

    def place_dev(x):
        idx = dev_index.get(id(x))
        if idx is None:
            dev_args.append(x)
            idx = len(dev_args) - 1
            dev_index[id(x)] = idx
        return ("dev", idx)

    def place(x):
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            if x.dtype == np.int32:
                kk = "i32"
                flat = x.ravel().view(np.uint32)
            elif x.dtype == np.float32:
                kk = "f32"
                flat = x.ravel().view(np.uint32)  # bit-exact carrier
            elif x.dtype == np.bool_ or x.dtype == np.uint8:
                kk = str(x.dtype)  # "bool" | "uint8"
                b = x.ravel().astype(np.uint8)
                pad = (-b.size) % 4
                if pad:
                    b = np.concatenate([b, np.zeros(pad, np.uint8)])
                flat = b.view(np.uint32)
            else:  # rare dtypes upload directly
                return place_dev(jnp.asarray(x))
            o = off["w32"]
            buf["w32"].append(flat)
            off["w32"] += flat.size
            return ("pk", kk, o, x.shape, str(x.dtype))
        if isinstance(x, tuple):
            return tuple(place(e) for e in x)
        # already a device array (pools, alive, previously uploaded rows)
        return place_dev(x)

    templates = tuple(
        (qis, place(args), tuple(sorted(kwargs.items())), fn)
        for qis, args, kwargs, fn in calls
    )
    buffers = {}
    parts = buf["w32"]
    if parts:
        # single-allocation pack: concatenate-then-pad touches every page
        # TWICE (concat alloc+copy, then np.pad alloc+copy+zero); on a host
        # whose anonymous-page zeroing is slow that doubles prepare cost.
        # One np.empty of the padded pow2 size (bucketed h2d shapes), fill
        # the parts, zero only the tail.
        total = off["w32"]
        cat = np.empty(_pow2(max(8, total)), np.uint32)
        o = 0
        for p in parts:
            cat[o : o + p.size] = p
            o += p.size
        cat[o:] = 0
        buffers["w32"] = jnp.asarray(cat)
    return templates, tuple(dev_args), buffers, {}


def _materialize(t, dev_args, buffers, sections=()):
    """Rebuild an args pytree from its template inside the fused trace.

    Every array is a 4-byte-aligned slice of the single packed u32 word
    buffer; non-i32 dtypes bitcast back (bit-exact, fused by XLA)."""
    import jax.numpy as jnp
    from jax import lax

    if t is None:
        return None
    if isinstance(t, tuple) and len(t) and t[0] == "dev":
        return dev_args[t[1]]
    if isinstance(t, tuple) and len(t) and t[0] == "pk":
        _, kk, o, shape, dt = t
        n = int(np.prod(shape)) if shape else 1
        if kk in ("bool", "uint8"):
            nw = (n + 3) // 4
            sl = lax.slice(buffers["w32"], (o,), (o + nw,))
            by = lax.bitcast_convert_type(sl, jnp.uint8).reshape(-1)[:n]
            if dt == "bool":
                by = by != 0
            return by.reshape(shape)
        sl = lax.slice(buffers["w32"], (o,), (o + n,))
        if kk == "f32":
            sl = lax.bitcast_convert_type(sl, jnp.float32)
        else:
            sl = lax.bitcast_convert_type(sl, jnp.int32)
        return sl.reshape(shape)
    return tuple(_materialize(e, dev_args, buffers, sections) for e in t)


def _template_key(templates, buffers, sections):
    """Hashable cache key: full static structure + buffer shape/bases."""

    def keyify(t):
        if t is None or (isinstance(t, tuple) and t and t[0] in ("dev", "pk")):
            return t if t is None or t[0] != "dev" else ("dev", t[1])
        return tuple(keyify(e) for e in t)

    return (
        tuple(
            (keyify(args), kw_items, fn) for _qis, args, kw_items, fn in templates
        ),
        tuple(sorted((kk, v.shape, str(v.dtype)) for kk, v in buffers.items())),
        tuple(sorted(sections.items())),
    )


class PreparedBatch:
    """Device-resident stacked batch; run() is pure dispatch.

    All signature groups FUSE into one jitted program: the whole batch —
    every tree shape, every row-count bucket — is a single device dispatch
    (one executable, one launch). Launch overhead is paid once per batch
    instead of once per group, XLA can overlap the groups' gathers, and
    the compiled program is cached GLOBALLY by batch structure, so a
    serving workload that keeps creating fresh batches of the same shape
    never recompiles and uploads each batch in <=3 packed transfers.
    """

    def __init__(self, num_queries: int, calls) -> None:
        self.num_queries = num_queries
        self._calls = calls
        (
            self._templates,
            self._dev_args,
            self._buffers,
            self._sections,
        ) = _pack_args(calls)
        self._key = _template_key(
            self._templates, self._buffers, self._sections
        )

    def run(self):
        """Per-query (scores [k], local docs [k]) as jax arrays (async)."""
        out = [None] * self.num_queries
        for (vals, docs), qis in self.run_grouped():
            for j, qi in enumerate(qis):
                out[qi] = (vals[j], docs[j])
        return out

    def run_grouped(self, fused: bool = True):
        """[(  (vals [Q,k], docs [Q,k]), query_indices ), ...] — one entry
        per signature group, computed in ONE device dispatch."""
        fn_cached = _FUSED_CACHE.get(self._key) if fused else None
        if fn_cached is not None:
            _FUSED_CACHE.move_to_end(self._key)
        if fused and fn_cached is None:
            templates = tuple(
                (args, kw_items, fn)
                for _qis, args, kw_items, fn in self._templates
            )
            sections = dict(self._sections)  # static, part of the key

            def _all(dev_args, buffers):
                # inner jitted fns trace through inline: one XLA program
                return tuple(
                    fn(
                        *_materialize(args, dev_args, buffers, sections),
                        **dict(kw_items),
                    )
                    for args, kw_items, fn in templates
                )

            fn_cached = jax.jit(_all)
            _FUSED_CACHE[self._key] = fn_cached
            while len(_FUSED_CACHE) > _FUSED_CACHE_MAX:
                _FUSED_CACHE.popitem(last=False)
        if fn_cached is not None:
            outs = fn_cached(self._dev_args, self._buffers)
            return [
                (out, qis) for out, (qis, *_r) in zip(outs, self._templates)
            ]
        # unfused: one dispatch per signature group (debug path)
        return [
            (
                fn(
                    *_materialize(
                        args, self._dev_args, self._buffers, self._sections
                    ),
                    **dict(kw_items),
                ),
                qis,
            )
            for qis, args, kw_items, fn in self._templates
        ]
