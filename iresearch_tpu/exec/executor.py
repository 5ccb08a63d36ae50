"""Jitted device query executor over the dense block-scan plan.

The reference's read hot path is doc_iterator::next/seek over bit-packed
128-doc blocks plus combinator trees (formats_10.cpp:2020-2425,
conjunction.hpp, disjunction.hpp). Here one XLA program per plan signature
does the whole query:

  gather rows        deltas[rows]            -> [R, 128]   (HBM gather)
  decode             base + cumsum(deltas)   -> doc ids    (VPU)
  score              score_block(...)        -> [R, 128]   (fused elementwise)
  scatter-add        per-leaf dense [L, nd]  score + match counts
  fold tree          elementwise and/or/not  (XLA fuses the whole fold)
  top-k              jax.lax.top_k(masked scores)

Padding rows point at sentinel row 0 (all-zero block): they decode to doc 0
with freq 0 and contribute exactly zero, so no masks are needed.
Score-vs-oracle note: scatter-add order differs from the host oracle's
per-term loop, so float sums can differ by ~1 ulp; tests compare with rtol.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import numpy as np

from iresearch_tpu.exec.plan import PlanCompiler, SegmentPlan
from iresearch_tpu.formats.bitpack import BITS
from iresearch_tpu.ops.topk import wide_top_k
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.host_eval import HostQuery
from iresearch_tpu.search.scorers import BM25, Scorer, score_block

_NEG_INF = float("-inf")


def _fold_tree(tree, leaf_match, leaf_score, aux_match, aux_score, nd, jnp):
    """Elementwise fold of the static boolean tree -> (match, score)."""
    kind = tree[0]
    if kind == "empty":
        return jnp.zeros(nd, bool), jnp.zeros(nd, jnp.float32)
    if kind == "all":
        return jnp.ones(nd, bool), jnp.zeros(nd, jnp.float32)
    if kind == "leaf":
        i = tree[1]
        return leaf_match[i], leaf_score[i]
    if kind == "aux":
        i = tree[1]
        return aux_match[i], aux_score[i]
    if kind == "not":
        m, _ = _fold_tree(tree[1], leaf_match, leaf_score, aux_match, aux_score, nd, jnp)
        return ~m, jnp.zeros(nd, jnp.float32)
    if kind in ("and", "or"):
        if kind == "and":
            _, pos, neg, merge = tree
            min_match = None
        else:
            _, pos, neg, min_match, merge = tree
        match = jnp.ones(nd, bool)
        count = jnp.zeros(nd, jnp.int32)
        # merge of matching children (ScoreMergeType, scorer.hpp:224-235)
        if merge == "max":
            score = jnp.full(nd, _NEG_INF, jnp.float32)
        elif merge == "min":
            score = jnp.full(nd, jnp.inf, jnp.float32)
        else:
            score = jnp.zeros(nd, jnp.float32)
        for c in pos:
            m, s = _fold_tree(c, leaf_match, leaf_score, aux_match, aux_score, nd, jnp)
            match = match & m
            count = count + m.astype(jnp.int32)
            if merge == "max":
                score = jnp.maximum(score, jnp.where(m, s, _NEG_INF))
            elif merge == "min":
                score = jnp.minimum(score, jnp.where(m, s, jnp.inf))
            elif merge == "sum":
                score = score + s
        score = jnp.where(jnp.isfinite(score), score, 0.0)
        if kind == "or":
            match = jnp.ones(nd, bool) if min_match <= 0 else count >= min_match
        for c in neg:
            m, _ = _fold_tree(c, leaf_match, leaf_score, aux_match, aux_score, nd, jnp)
            match = match & ~m
        return match, jnp.where(match, score, 0.0)
    raise ValueError(f"bad tree node {tree!r}")


def _group_contrib(
    pool, rows_d, rows_f, rows_n, w, bd: int, bf: int, bn: int, avgdl, scorer,
    want_dl: bool = False,
):
    """Decode one row group -> (docs i32 [R,128], scores f32, matched bool).

    The reference's doc_iterator refill loop (formats_10.cpp:2089-2120) as
    one fused vector pass: unpack, prefix-sum, doc-length read, score.
    With inline norm pools (format v5, bn >= 0) the doc length comes from
    the same sequential row-gather path as freqs; legacy segments
    (bn == -1) fall back to the per-lane norms[docs] random gather
    (it dominated query time when measured — the reason v5 exists).
    """
    import jax.numpy as jnp

    from iresearch_tpu.formats.bitpack import unpack_jnp

    doc_words, freq_words, nrm_words, base, norms = pool
    d = unpack_jnp(doc_words[rows_d], bd).astype(jnp.int32)  # [R, 128]
    docs = base[rows_d][:, None] + jnp.cumsum(d, axis=1)
    f = unpack_jnp(freq_words[rows_f], bf).astype(jnp.float32)
    if bn >= 0:
        # pad lanes carry norm 0 -> clamp to 1 to keep tf math finite
        # (their freq is 0, so they never match or score anyway)
        dl = jnp.maximum(
            unpack_jnp(nrm_words[rows_n], bn).astype(jnp.float32), 1.0
        )
    else:
        dl = norms[docs]
    sc = score_block(scorer, w[:, None], f, dl, avgdl, xp=jnp)
    if want_dl:
        return docs, sc, f > 0, dl
    return docs, sc, f > 0


def _dense_contrib(dargs, dstat, scorer, nd, jnp, keep=None):
    """One dense-grid span's (score, match) over the [nd] doc axis.

    The span's freqs live in grid order (formats/dense.py): rows
    [start, start+ndrows) of its class pool unpack to [ndrows, 128] =
    the doc axis — placement is the identity, so the contribution is a
    sequential unpack + elementwise score at HBM stream speed. ``keep``
    optionally masks rows (WAND pruning — monotone-safe: masking can
    only shrink matches and scores)."""
    from jax import lax

    from iresearch_tpu.formats.bitpack import unpack_jnp

    pool, start, w, norms_g, avgdl_d = dargs[:5]
    bits, _leaf, ndrows = dstat[:3]
    words = lax.dynamic_slice_in_dim(pool, start, ndrows)
    freq = unpack_jnp(words, bits).astype(jnp.float32)  # [ndrows, 128]
    if keep is not None:
        freq = freq * keep[:, None].astype(jnp.float32)
    f = freq.reshape(nd)
    sc = score_block(scorer, w, f, norms_g, avgdl_d, xp=jnp)
    m = f > 0
    return jnp.where(m, sc, 0.0), m


def wand_body(
    pools,  # tuple per group: (doc_words, freq_words, base, norms)
    rowsets,  # tuple per group: (rows_d, rows_f, w, leaf, ub, other) each [R]
    avgdl,  # f32 [num_groups]
    leaf_min,  # i32 [L]
    alive,  # bool [nd]
    *,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    k: int,
    nd: int,
    sample: int,
    mode: str = "exact",  # "exact" | "strict" | "approx"
    dense_args=(),  # per dense span: (pool, start, w, norms, avgdl, ub, other)
    dense_static=(),  # per dense span: (bits, leaf, ndrows) — static
):
    """Block-max WAND top-k for sum-merged positive boolean trees.

    Reference: the wanderator (formats_10.cpp:2426-2825) skips blocks whose
    skip-list score bound is below the running threshold; BlockConjunction
    carries bounds through ANDs (conjunction.hpp:231). Dense analog:
    (1) sort blocks by upper bound, decode only the top `sample` blocks per
    group, run the full tree fold on the partial arrays, take the k-th
    partial score as a LOWER bound θ of the true k-th (partial decode can
    only shrink matches/scores); (2) redirect every block with
    ub + other_spans_max < θ to sentinel row 0 — its HBM reads collapse to
    one cached row — and run the normal dense pass. Exact: any doc in a
    block has total score ≤ ub + other, so every block containing a true
    top-k doc survives, and survivors keep ALL their contributions.

    ``mode`` is the reference's WandContext speed/recall knob
    (index_reader_options.hpp:48-56):
    - "exact"  (default): θ shaved by a relative epsilon so float-order
      differences between the sampled and full passes can never prune a
      true top-k block — the analog of the reference's weak/nextafter
      threshold (formats_10.cpp:2434-2441), made fully exact.
    - "strict": θ used as-is (MinStrict, formats_10.cpp:2434). Blocks
      whose bound ties the sampled k-th within float-reorder ulps may be
      pruned, so a k-th doc tied at θ can be replaced by its neighbor.
    - "approx": return the sampled pass's top-k directly — ONE pass that
      decodes only the `sample` highest-bound blocks per group. The real
      speed lever: work drops from all-blocks to sample·groups; recall
      degrades gracefully (every returned doc's score is a lower bound
      of its true score).
    """
    import jax.numpy as jnp
    from jax import lax

    def fold_pass(sets, slicer, dense_keep):
        leaf_score = jnp.zeros((num_leaves, nd), jnp.float32)
        leaf_count = jnp.zeros((num_leaves, nd), jnp.int32)
        for gi, (pool, rs) in enumerate(zip(pools, sets)):
            bd, bf, bn = gbits[gi]
            rows_d, rows_f, rows_n, w, leaf = slicer(rs)
            docs, sc, m = _group_contrib(
                pool, rows_d, rows_f, rows_n, w, bd, bf, bn, avgdl[gi], scorer
            )
            leaf_ix = leaf[:, None]
            leaf_score = leaf_score.at[leaf_ix, docs].add(sc, mode="drop")
            leaf_count = leaf_count.at[leaf_ix, docs].add(
                m.astype(jnp.int32), mode="drop"
            )
        for di, (dargs, dstat) in enumerate(zip(dense_args, dense_static)):
            sc, m = _dense_contrib(
                dargs, dstat, scorer, nd, jnp, keep=dense_keep(di, dargs)
            )
            leaf_score = leaf_score.at[dstat[1]].add(sc)
            leaf_count = leaf_count.at[dstat[1]].add(m.astype(jnp.int32))
        leaf_match = leaf_count >= leaf_min[:, None]
        leaf_score = jnp.where(leaf_match, leaf_score, 0.0)
        match, score = _fold_tree(
            tree, leaf_match, leaf_score, None, None, nd, jnp
        )
        return match & alive, score

    sorted_sets = []
    for rows_d, rows_f, rows_n, w, leaf, ub, other in rowsets:
        order = jnp.argsort(-ub)
        sorted_sets.append(
            (rows_d[order], rows_f[order], rows_n[order], w[order],
             leaf[order], ub[order], other[order])
        )

    # phase 1: θ from the highest-bound `sample` blocks of each group.
    # Dense spans mask to their top-`sample` rows by row upper bound
    # (ties keep extra rows — more sampled decode only tightens θ, which
    # stays a lower bound of the true k-th)
    def dense_sample_keep(di, dargs):
        ub = dargs[5]
        s = min(sample, ub.shape[0])
        thresh = lax.top_k(ub, s)[0][s - 1]
        return ub >= thresh

    pm, ps = fold_pass(
        sorted_sets,
        lambda rs: tuple(
            r[: min(sample, r.shape[0])] for r in rs[:5]
        ),
        dense_sample_keep,
    )
    if mode == "approx":
        return wide_top_k(jnp.where(pm, ps, _NEG_INF), k)
    theta = wide_top_k(jnp.where(pm, ps, _NEG_INF), k)[0][k - 1]
    if mode != "strict":
        # Safety margin: the sampled pass sums contributions in a
        # different order than the full pass, so θ can sit a few ulp
        # above the true k-th score; shave a relative epsilon so no true
        # top-k block is pruned (the analog of the reference's nextafter
        # dance, formats_10.cpp:2434-2441). -inf stays -inf.
        theta = jnp.where(
            jnp.isfinite(theta), theta - jnp.abs(theta) * 1e-5 - 1e-30, theta
        )

    # phase 2: full pass with sub-threshold blocks parked on the sentinel
    def prune(rs):
        rows_d, rows_f, rows_n, w, leaf, ub, other = rs
        keep = (ub + other) >= theta
        return (
            jnp.where(keep, rows_d, 0),
            jnp.where(keep, rows_f, 0),
            jnp.where(keep, rows_n, 0),
            jnp.where(keep, w, 0.0),
            leaf,
        )

    match, score = fold_pass(
        sorted_sets,
        prune,
        lambda di, dargs: (dargs[5] + dargs[6]) >= theta,
    )
    vals, docs = wide_top_k(jnp.where(match, score, _NEG_INF), k)
    return vals, docs


@partial(
    jax.jit,
    static_argnames=(
        "tree", "gbits", "scorer", "num_leaves", "k", "nd", "sample",
        "wand_mode", "dense_static",
    ),
)
def _run_segment_wand(
    pools,
    rowsets,
    avgdl,
    leaf_min,
    alive,
    dense_args=(),
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


@partial(
    jax.jit,
    static_argnames=(
        "tree", "gbits", "scorer", "num_leaves", "k", "mode",
        "driver_gi", "group_leaf", "wand", "sample", "wand_mode", "nd",
        "dense_static",
    ),
)
def _run_segment_candidates(
    pools,
    rowsets,
    avgdl,
    leaf_min,
    alive,
    nreal,
    dense_args=(),
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
    """Scale-proportional tiers (exec/candidates.py): work ∝ postings."""
    from iresearch_tpu.exec.candidates import candidate_body

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


_USE_DENSE_SCAN = (
    __import__("os").environ.get("IRS_DENSE_SCAN", "1") != "0"
)
_USE_SKYLINE = (
    __import__("os").environ.get("IRS_SKYLINE", "1") != "0"
)


@partial(
    jax.jit,
    static_argnames=("scorer", "span_bits", "k", "ndrows", "conj", "mm"),
)
def _run_segment_skyline(
    span_pools, norms_grid, row_ids, starts, ws, avgdl,
    *, scorer, span_bits, k, ndrows, conj=False, mm=1,
):
    """Survivor-row gather + exact rescore (exec/skyline.py): the θ-pruned
    analog of the reference wanderator's block skipping
    (formats_10.cpp:2426-2825) for dense-grid sum trees — disjunctive,
    conjunctive (conjunction.hpp:231-436), or min_match
    (disjunction.hpp:860-1100)."""
    from iresearch_tpu.exec.skyline import skyline_topk

    return skyline_topk(
        span_pools, norms_grid, row_ids, starts, ws, avgdl,
        scorer=scorer, span_bits=span_bits, k=k, ndrows=ndrows, conj=conj,
        mm=mm,
    )


def dslice_shape(plan, pool):
    """(R, starts) for the contiguous-slice decode: the group's pow2 row
    bucket clamped to the (pow2-padded) pool row counts — tiny pools in
    test segments can be smaller than the minimum bucket of 8; ``nreal``
    masks the clamp's slack either way."""
    g = plan.groups[0]
    doc_words, freq_words, nrm_words, _base, _norms = pool
    R = min(
        len(g.rows_d),
        doc_words.shape[0],
        freq_words.shape[0],
        nrm_words.shape[0],
    )
    starts = np.asarray(
        [g.rows_d[0], g.rows_f[0], g.rows_n[0]], np.int32
    )
    return R, starts


@partial(jax.jit, static_argnames=("gbits", "scorer", "k", "R"))
def _run_segment_dslice(
    pool, starts, nreal, w, avgdl, alive, *, gbits, scorer, k, R
):
    """Contiguous-slice single-term top-k (exec/candidates.py:dslice_topk)."""
    from iresearch_tpu.exec.candidates import dslice_topk

    return dslice_topk(
        pool, starts, nreal, w, avgdl, alive,
        gbits=gbits, scorer=scorer, k=k, R=R,
    )


def scan_shape(plan):
    """Fused-scan eligibility of a plan: None, "or" (any-hit, spans sum
    into one leaf), "and" (all-hit, one span per leaf), or int mm >= 2
    (a min_match disjunction, one span per leaf — the fused analog of
    the reference's min-match block pruning, disjunction.hpp:860-1100)."""
    if (
        plan.exec_mode != "dense"
        or plan.groups
        or not plan.dense_spans
        or plan.aux_pairs is not None
        or plan.device_aux
    ):
        return None
    L = plan.num_leaves
    if any(int(m) > 1 for m in plan.leaf_min_match[:L]):
        return None
    if plan.tree == ("leaf", 0) and L == 1:
        return "or"
    t = plan.tree
    if (
        t[0] in ("and", "or")
        and not t[2]
        and t[4 if t[0] == "or" else 3] == "sum"
        and all(c[0] == "leaf" for c in t[1])
        and sorted(c[1] for c in t[1]) == list(range(L))
        and [ds.leaf for ds in plan.dense_spans] == list(range(L))
    ):
        if t[0] == "and":
            return "and"
        if int(t[3]) >= 2:
            return int(t[3])
    return None


@partial(
    jax.jit,
    static_argnames=(
        "scorer", "span_bits", "k", "conj", "mm",
    ),
)
def _run_dense_scan(
    span_pools, span_starts, span_w, norms_grid, avgdl,
    *, scorer, span_bits, k, conj=False, mm=1,
):
    """Fused scan fast path (ops/dense_scan.py): sum trees whose spans
    are all dense-grid resident — disjunctive, conjunctive, or
    min_match."""
    from jax import lax

    from iresearch_tpu.ops.dense_scan import dense_scan_topk

    ndrows = norms_grid.shape[0]
    words = tuple(
        lax.dynamic_slice(p, (s, jnp_zero()), (ndrows, p.shape[1]))
        for p, s in zip(span_pools, span_starts)
    )
    return dense_scan_topk(
        words, span_w, norms_grid, avgdl,
        scorer=scorer, span_bits=span_bits, k=k, conj=conj, mm=mm,
    )


def jnp_zero():
    import jax.numpy as jnp

    return jnp.int32(0)


def segment_body(
    pools,  # tuple per group: (doc_words, freq_words, base, norms)
    rowsets,  # tuple per group: (rows_d i32[R], rows_f i32[R], w f32[R], leaf i32[R])
    avgdl,  # f32 [num_groups]
    leaf_min,  # i32 [L]
    aux_match,  # bool [A, nd] or None
    aux_score,  # f32 [A, nd] or None
    alive,  # bool [nd]
    *,
    tree,
    gbits,  # tuple per group: (doc_bits, freq_bits) — static
    scorer: Scorer,
    num_leaves: int,
    nd: int,
    dense_args=(),  # per dense span: (pool, start, w, norms, avgdl)
    dense_static=(),  # per dense span: (bits, leaf, ndrows) — static
):
    """Dense (match, score) over one segment's padded doc axis.

    Shared by the single-chip executor and the shard_map scale-out path
    (parallel/sharded.py) — semantics defined once.
    """
    import jax.numpy as jnp

    from iresearch_tpu.formats.bitpack import unpack_jnp

    leaf_score = jnp.zeros((num_leaves, nd), jnp.float32)
    leaf_count = jnp.zeros((num_leaves, nd), jnp.int32)
    for gi, (pool, (rows_d, rows_f, rows_n, w, leaf)) in enumerate(
        zip(pools, rowsets)
    ):
        bd, bf, bn = gbits[gi]
        docs, sc, matched = _group_contrib(
            pool, rows_d, rows_f, rows_n, w, bd, bf, bn, avgdl[gi], scorer
        )
        leaf_ix = leaf[:, None]
        leaf_score = leaf_score.at[leaf_ix, docs].add(sc, mode="drop")
        leaf_count = leaf_count.at[leaf_ix, docs].add(
            matched.astype(jnp.int32), mode="drop"
        )
    for dargs, dstat in zip(dense_args, dense_static):
        sc, m = _dense_contrib(dargs, dstat, scorer, nd, jnp)
        leaf_score = leaf_score.at[dstat[1]].add(sc)
        leaf_count = leaf_count.at[dstat[1]].add(m.astype(jnp.int32))

    leaf_match = leaf_count >= leaf_min[:, None]
    leaf_score = jnp.where(leaf_match, leaf_score, 0.0)

    match, score = _fold_tree(
        tree, leaf_match, leaf_score, aux_match, aux_score, nd, jnp
    )
    match = match & alive
    return match, score


@partial(
    jax.jit,
    static_argnames=(
        "tree", "gbits", "scorer", "num_leaves", "k", "nd", "dense_static"
    ),
)
def _run_segment(
    pools,
    rowsets,
    avgdl,
    leaf_min,
    aux_match,
    aux_score,
    alive,
    dense_args=(),
    *,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    k: int,
    nd: int,
    dense_static=(),
):
    import jax.numpy as jnp
    from jax import lax

    match, score = segment_body(
        pools,
        rowsets,
        avgdl,
        leaf_min,
        aux_match,
        aux_score,
        alive,
        tree=tree,
        gbits=gbits,
        scorer=scorer,
        num_leaves=num_leaves,
        nd=nd,
        dense_args=dense_args,
        dense_static=dense_static,
    )
    masked = jnp.where(match, score, _NEG_INF)
    vals, docs = wide_top_k(masked, k)
    return vals, docs


class DeviceQuery:
    """A prepared query executing on device, exact vs the host oracle.

    Prepare (term expansion, stats collection) is shared with HostQuery so
    sampled terms and idf stats are identical by construction.
    """

    def __init__(
        self,
        flt: F.Filter,
        segments: Sequence,
        scorer: Optional[Scorer] = None,
        wand: bool = False,
        wand_sample: int = 16,
        wand_mode: str = "exact",
        device_phrase: bool = True,
    ) -> None:
        if wand_mode not in ("exact", "strict", "approx"):
            raise ValueError(f"wand_mode must be exact|strict|approx, got {wand_mode!r}")
        self.flt = flt
        self.scorer = scorer or BM25()
        self.wand = wand
        self.wand_sample = wand_sample
        self.wand_mode = wand_mode
        self.device_phrase = device_phrase
        self.prepared = HostQuery(flt, list(segments), self.scorer)
        self.compiler = PlanCompiler(self.prepared, self.scorer)
        self._plans: Dict[int, SegmentPlan] = {}

    def plan(self, seg_idx: int) -> SegmentPlan:
        p = self._plans.get(seg_idx)
        if p is None:
            from iresearch_tpu.exec.plancache import get_plan

            p = get_plan(
                self.compiler,
                self.flt,
                seg_idx,
                wand=self.wand,
                device_phrase=self.device_phrase,
                scorer=self.scorer,
            )
            self._plans[seg_idx] = p
        return p

    def plan_for_k(self, seg_idx: int, k: int) -> SegmentPlan:
        """Plan valid for a top-k of ``k``: scored-only multiterm plans
        (plan.scored_only_kmax) fall back to the full plan beyond their
        guard (rare: k > 128)."""
        p = self.plan(seg_idx)
        if 0 < p.scored_only_kmax < k:
            full = getattr(self, "_full_plans", None)
            if full is None:
                full = self._full_plans = {}
            p = full.get(seg_idx)
            if p is None:
                p = self.compiler.compile(
                    self.flt,
                    seg_idx,
                    wand=self.wand,
                    device_phrase=self.device_phrase,
                    scored_only=False,
                )
                full[seg_idx] = p
        return p

    def _device_inputs(self, plan: SegmentPlan):
        # keyed on the plan itself: cached plans (exec/plancache.py) then
        # share uploads across DeviceQuery instances
        cached = plan.cache.get("devin")
        if cached is not None:
            return cached
        out = self._build_device_inputs(plan)
        plan.cache["devin"] = out
        return out

    def _build_device_inputs(self, plan: SegmentPlan):
        import jax.numpy as jnp

        sr = self.prepared.segments[plan.seg_idx]
        dseg = sr.device()
        pools = []
        rowsets = []
        gbits = []
        for g in plan.groups:
            dfield = sr.device_field(g.field_name)
            has_nrm = dfield.nrm_words is not None and g.ncls >= 0
            pools.append(
                (
                    dfield.doc_words[g.dcls],
                    dfield.freq_words[g.fcls],
                    # legacy segments: freq pool stands in (unused, bn=-1)
                    dfield.nrm_words[g.ncls] if has_nrm
                    else dfield.freq_words[g.fcls],
                    dfield.base[g.dcls],
                    dfield.norms,
                )
            )
            rowsets.append(
                (
                    jnp.asarray(g.rows_d),
                    jnp.asarray(g.rows_f),
                    jnp.asarray(g.rows_n),
                    jnp.asarray(g.weight),
                    jnp.asarray(g.leaf),
                )
            )
            gbits.append(
                (BITS[g.dcls], BITS[g.fcls], BITS[g.ncls] if has_nrm else -1)
            )
        # host-aux results upload SPARSELY: (match docs, scores) instead
        # of [A, nd] dense arrays — a ByNested/ngram/column aux at 5M docs
        # shipped ~42 MB per aux per query before; now O(matches)
        # (reference analog: iterators yield only matching docs). The
        # dense [A, nd] arrays the fold consumes are scattered ON DEVICE
        # and cached with the rest of the device inputs.
        am = asc = None
        if plan.aux_pairs is not None:
            A = len(plan.aux_pairs)
            nd_p = plan.nd_pad
            dev_idx = {i for i, _ in plan.device_aux}
            am = jnp.zeros((A, nd_p), jnp.bool_)
            asc = jnp.zeros((A, nd_p), jnp.float32)
            for a, (docs_a, vals_a) in enumerate(plan.aux_pairs):
                if a in dev_idx:
                    continue  # filled by the device phrase below
                am = am.at[a, jnp.asarray(docs_a)].set(True, mode="drop")
                asc = asc.at[a, jnp.asarray(docs_a)].set(
                    jnp.asarray(vals_a), mode="drop"
                )
        if plan.device_aux:
            from iresearch_tpu.exec.phrase import run_phrase_dense

            for aux_idx, spec in plan.device_aux:
                m, s = run_phrase_dense(spec, sr, self.scorer, plan.nd_pad)
                am = am.at[aux_idx].set(m)
                asc = asc.at[aux_idx].set(s)
        # everything uploaded once; re-dispatch is then upload-free
        if plan.groups and plan.groups[0].ub is not None:
            rowsets = [
                rs + (jnp.asarray(g.ub), jnp.asarray(g.other))
                for rs, g in zip(rowsets, plan.groups)
            ]
        avgdl_j = jnp.asarray(plan.group_avgdl)
        leafmin_j = jnp.asarray(plan.leaf_min_match)
        # dense-grid spans (plan.dense_spans): pool upload is lazy and
        # shared per (field, class); per-span scalars ride the pytree.
        # same_dl: under the join tier, probed spans may reuse the
        # candidate span's decoded doc length ONLY if every candidate-
        # generating group is in the span's own field (dl is per-(doc,
        # field)).
        cand_fields = None
        if plan.exec_mode == "join":
            if plan.driver_gi >= 0:
                cand_fields = {plan.groups[plan.driver_gi].field_name}
            else:
                cand_fields = {g.field_name for g in plan.groups}
        dense_args = []
        dense_static = []
        for ds in plan.dense_spans:
            dfield = sr.device_field(ds.field_name)
            cache = sr.dense_cache(ds.field_name)
            pool = dfield.dense_words(cache, ds.cls)
            args = (
                pool,
                jnp.int32(ds.start),
                jnp.float32(ds.w),
                dfield.norms,
                jnp.float32(ds.avgdl),
            )
            if ds.ub is not None:
                args = args + (jnp.asarray(ds.ub), jnp.float32(ds.other))
            dense_args.append(args)
            same_dl = cand_fields is None or cand_fields == {ds.field_name}
            dense_static.append((BITS[ds.cls], ds.leaf, ds.ndrows, same_dl))
        return (
            tuple(pools),
            tuple(rowsets),
            tuple(gbits),
            am,
            asc,
            dseg.alive,
            avgdl_j,
            leafmin_j,
            tuple(dense_args),
            tuple(dense_static),
        )

    def execute_segment(self, seg_idx: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-segment top-k -> (scores f32[k], local docs i32[k]).

        Entries with score == -inf are non-matches (k exceeded matches).
        """
        vals, docs = self.execute_segment_async(seg_idx, k)
        return np.asarray(vals), np.asarray(docs)

    def execute_segment_async(self, seg_idx: int, k: int):
        """Like execute_segment but returns device (jax) arrays without a
        host fetch — the serving hot path (results stay on device until
        the response is assembled)."""
        plan = self.plan_for_k(seg_idx, k)
        (
            pools,
            rowsets,
            gbits,
            am,
            asc,
            alive,
            avgdl_j,
            leafmin_j,
            dense_args,
            dense_static,
        ) = self._device_inputs(plan)
        kk = min(k, plan.nd_pad)
        wand_on = (bool(plan.groups) and plan.groups[0].ub is not None) or any(
            ds.ub is not None for ds in plan.dense_spans
        )
        sr0 = self.prepared.segments[plan.seg_idx]
        shape = scan_shape(plan) if _USE_DENSE_SCAN else None
        from iresearch_tpu.exec.skyline import skyline_shape

        sky_shape = skyline_shape(plan) if _USE_SKYLINE else None
        # deletes need no gate on the grid tiers: the dense cache zeroes
        # deleted docs' freqs at build (formats/dense.py)
        if sky_shape is not None:
            # device inputs cached per (plan, k): the serving loop must
            # not upload fresh scalars per call
            sky = plan.cache.get(("sky", kk))
            if sky is None:
                from iresearch_tpu.exec.skyline import skyline_spec

                spec = skyline_spec(plan, sr0, self.scorer, kk)
                if spec is None:
                    sky = (None, None)
                else:
                    import jax.numpy as jnp

                    dfield = sr0.device_field(spec.field_name)
                    cache = sr0.dense_cache(spec.field_name)
                    args = (
                        tuple(
                            dfield.dense_words(cache, c)
                            for c in spec.classes
                        ),
                        dfield.norms_grid(),
                        jnp.asarray(spec.row_ids),
                        tuple(jnp.int32(s) for s in spec.starts),
                        tuple(jnp.float32(w) for w in spec.ws),
                        jnp.float32(spec.avgdl),
                    )
                    sky = (args, spec)
                plan.cache[("sky", kk)] = sky
            if sky[0] is not None:
                args, spec = sky
                return _run_segment_skyline(
                    *args,
                    scorer=self.scorer,
                    span_bits=tuple(BITS[c] for c in spec.classes),
                    k=kk,
                    ndrows=spec.ndrows,
                    conj=spec.conj,
                    mm=spec.min_match,
                )
        if (
            shape is not None
            # single spans run faster through the plain fused fold; the
            # scan's row-max+refine wins once spans multiply
            and (len(plan.dense_spans) >= 2 or shape == "and")
            and len({ds.field_name for ds in plan.dense_spans}) == 1
        ):
            cached = plan.cache.get("scan")
            if cached is None:
                import jax.numpy as jnp

                dfield = sr0.device_field(plan.dense_spans[0].field_name)
                cached = (
                    tuple(
                        sr0.device_field(ds.field_name).dense_words(
                            sr0.dense_cache(ds.field_name), ds.cls
                        )
                        for ds in plan.dense_spans
                    ),
                    tuple(jnp.int32(ds.start) for ds in plan.dense_spans),
                    tuple(jnp.float32(ds.w) for ds in plan.dense_spans),
                    dfield.norms_grid(),
                    jnp.float32(plan.dense_spans[0].avgdl),
                )
                plan.cache["scan"] = cached
            span_pools, starts, ws, norms_g, avgdl_s = cached
            return _run_dense_scan(
                span_pools,
                starts,
                ws,
                norms_g,
                avgdl_s,
                scorer=self.scorer,
                span_bits=tuple(BITS[ds.cls] for ds in plan.dense_spans),
                k=kk,
                conj=shape == "and",
                mm=shape if isinstance(shape, int) else 1,
            )
        if plan.exec_mode == "dslice":
            import jax.numpy as jnp

            g = plan.groups[0]
            R, starts = dslice_shape(plan, pools[0])
            sr = self.prepared.segments[plan.seg_idx]
            vals, docs = _run_segment_dslice(
                pools[0],
                jnp.asarray(starts),
                jnp.int32(g.real_rows),
                jnp.float32(g.weight[0]),
                avgdl_j[0],
                alive if sr.has_deletes else None,
                gbits=gbits[0],
                scorer=self.scorer,
                k=min(kk, R * 128),
                R=R,
            )
            return vals, docs
        if plan.exec_mode != "dense":
            import jax.numpy as jnp

            if plan.exec_mode == "join":
                lanes = len(plan.groups[plan.driver_gi].rows_d) * 128
            elif plan.exec_mode == "gridmix":
                lanes = plan.nd_pad  # the grid view covers every doc
            else:
                lanes = sum(len(g.rows_d) for g in plan.groups) * 128
            max_rows = max(len(g.rows_d) for g in plan.groups)
            # pruning cannot skip anything the sampled pass would not
            # already decode — drop the redundant θ phase for short lists
            wand_eff = wand_on and max_rows > self.wand_sample
            nreal = jnp.asarray(
                [g.real_rows * 128 for g in plan.groups], jnp.int32
            )
            group_leaf = tuple(int(g.leaf[0]) for g in plan.groups)
            sr = self.prepared.segments[plan.seg_idx]
            vals, docs = _run_segment_candidates(
                pools,
                rowsets,
                avgdl_j,
                leafmin_j,
                # skip the per-lane alive gather when nothing is deleted
                alive if sr.has_deletes else None,
                nreal,
                dense_args,
                tree=plan.tree,
                gbits=gbits,
                scorer=self.scorer,
                num_leaves=plan.num_leaves,
                k=min(kk, lanes),
                mode=plan.exec_mode,
                driver_gi=plan.driver_gi,
                group_leaf=group_leaf,
                wand=wand_eff,
                sample=self.wand_sample,
                wand_mode=self.wand_mode,
                nd=plan.nd_pad,
                dense_static=dense_static,
            )
            return vals, docs
        if wand_on:
            vals, docs = _run_segment_wand(
                pools,
                rowsets,
                avgdl_j,
                leafmin_j,
                alive,
                dense_args,
                tree=plan.tree,
                gbits=gbits,
                scorer=self.scorer,
                num_leaves=plan.num_leaves,
                k=kk,
                nd=plan.nd_pad,
                sample=self.wand_sample,
                wand_mode=self.wand_mode,
                dense_static=dense_static,
            )
            return vals, docs
        vals, docs = _run_segment(
            pools,
            rowsets,
            avgdl_j,
            leafmin_j,
            am,
            asc,
            alive,
            dense_args,
            tree=plan.tree,
            gbits=gbits,
            scorer=self.scorer,
            num_leaves=plan.num_leaves,
            k=kk,
            nd=plan.nd_pad,
            dense_static=dense_static,
        )
        return vals, docs

    def top_k(self, k: int) -> List[Tuple[int, float]]:
        """Global top-k (global_doc, score), ordered by (-score, doc)."""
        out: List[Tuple[int, float]] = []
        base = 0
        for s, sr in enumerate(self.prepared.segments):
            vals, docs = self.execute_segment(s, k)
            for v, d in zip(vals, docs):
                if math.isinf(v) and v < 0:
                    continue
                out.append((base + int(d), float(v)))
            base += sr.num_docs
        out.sort(key=lambda t: (-t[1], t[0]))
        return out[:k]


def search_device(
    reader, flt: F.Filter, scorer: Optional[Scorer] = None, k: int = 10
) -> List[Tuple[int, float]]:
    """Device twin of host_eval.search: top-k (global_doc, score)."""
    q = DeviceQuery(flt, list(reader.segments), scorer)
    return q.top_k(k)
