"""Skyline execution: survivor-row gather for dense-grid sum trees.

The fused row-max scan (ops/dense_scan.py) reads every grid row of every
span — ~16 MB of HBM per term query at 5M docs. But the top-k threshold
θ prunes almost all of that: the reference's wanderator skips sub-θ
blocks via skip-list bounds (formats_10.cpp:2426-2825). The device
analog precomputes, per (field, scorer), row-aligned score UPPER bounds
for each dense span; at query time the host derives

  * θ — a provable lower bound of the true k-th score, from per-row
    ACHIEVABLE score pairs (real lanes recorded at cache build), and
  * the survivor row set — all dense spans of a field share ONE grid row
    space (row r = docs [128r, 128r+128)), so a row can host a winner
    only if Σ_s w_s·ub_s[r] ≥ θ; a vectorized row-sum + flatnonzero
    yields the exact minimal row set (single spans take an O(log n)
    searchsorted over a precomputed ub-descending permutation instead),

so the device only gathers those M rows and rescores them EXACTLY.
With default BM25 at the cache build avgdl the recorded champion pair is
the row's true argmax, making ub tight: M collapses to ~k rows even for
the hottest 5M-doc terms (measured 4000x pruning).

Exactness proof (disjunctive sum tree, no deletes):
  θ: span s's k best achievable row scores belong to k DISTINCT docs
  (one champion lane per row) whose total score ≥ their s-contribution,
  so the true k-th score θ* ≥ max_s w_s·lb_top_s[k-1] = θ.
  Coverage: a winner doc d has Σ_s w_s·ub_s[row(d)] ≥ score(d) ≥ θ* ≥
  θ — row(d) is in the survivor set (ties inclusive). A relative
  epsilon absorbs float-order drift between the host-computed θ and
  device-computed scores (the same guard as WAND, formats_10.cpp:2434).

Conjunctive (And) sum trees prune too: a row can host an all-hit winner
only if every span hits it (min over spans of bmaxf > 0) AND
Σ_s w_s·ub_s[r] ≥ θ. θ for And comes from an exact HOST rescore of the
top-C candidate rows by Σ ub (the grid pools are host numpy — unpacking
a few hundred rows is microseconds): the k-th best actual all-hit score
is a true lower bound of the k-th conjunctive score, so coverage holds
by the same argument (score(d) ≤ Σ w_s·ub_s[row(d)] for any match d).
The reference's analog is WAND-through-AND via BlockConjunction
shallow_seek (conjunction.hpp:231-436).

Deletes are handled upstream: the dense grid zeroes deleted docs' freqs
at cache build (formats/dense.py), so row bounds, champion pairs and
rescores are alive-only by construction.

Ineligible shapes (k > 128, zero θ, weak pruning per the scan-ratio
cost gate) fall back to the fused scan — exact either way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from iresearch_tpu.formats.bitpack import BITS
from iresearch_tpu.formats.spec import BLOCK as BLOCK_L, NUM_CLASSES
from iresearch_tpu.search.scorers import BM25, TFIDF, Scorer, score_block

_IMAX32 = 2**31 - 1
_NEG_INF = float("-inf")

# survivor-row budget per query; beyond this the full fused scan is
# cheaper anyway (it streams all rows with no gather)
SKYLINE_MAX_ROWS = int(os.environ.get("IRS_SKYLINE_MAX_ROWS", "8192"))
# relative cost gate: the fused scan streams S*ndrows packed rows at
# ~2 ns/row/span/query in a BATCHED vmap (64-78 queries per dispatch,
# measured 0.163 ms/query at 5M docs, S=2) while skyline row-gathers run
# at ~0.11-0.125 us/row — gathering more than S*ndrows/RATIO rows loses
# to just scanning. Crossover M* ~= 650*S rows at 5M; RATIO 48 keeps the
# gate slightly scan-biased (round 2 shipped RATIO=6 from a single-query
# scan measurement of 1.3 ms/q; the batched scan is ~8x cheaper per
# query, moving the crossover the same factor). Tests on tiny grids set
# this to 0 to force the skyline path regardless.
SKYLINE_SCAN_RATIO = float(os.environ.get("IRS_SKYLINE_SCAN_RATIO", "48"))
# θ needs the k-th best achievable row score per span; keep the top
# K_MAX per term (k beyond that falls back to the scan)
K_MAX = 128


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class SkylineIndex:
    """Per-(field, scorer, avgdl) row bounds over a DenseCache.

    Host side, per class: ``ub`` f32 [rows_c] row-aligned upper bounds;
    ``perm``/``ub_sorted`` the ub-descending permutation per span (for
    O(log n) single-span selection); per term the top-K_MAX achievable
    row scores (θ source).
    """

    def __init__(self, cache, scorer: Scorer, avgdl: float) -> None:
        self.cache = cache
        self.scorer = scorer
        self.avgdl = float(avgdl)
        ndrows = cache.ndrows
        self.ub: List[np.ndarray] = []
        self.perm: List[np.ndarray] = []
        self.ub_sorted: List[np.ndarray] = []
        self.lb_top: Dict[int, np.ndarray] = {}
        self.host_bytes = 0
        # exact row-max bound: the champion pair (f_c, dl_c) was selected
        # under DEFAULT BM25 constants at the cache's build avgdl — when
        # the query scores with exactly that formula, score(f_c, dl_c) IS
        # the row's true max (measured: survivor counts drop from ~60% of
        # the grid to ~k rows for the hottest 5M-doc terms)
        exact = (
            isinstance(scorer, BM25)
            and scorer.k == 1.2
            and scorer.b == 0.75
            and abs(self.avgdl - cache.avgdl)
            <= 1e-6 * max(1.0, cache.avgdl)
        )
        for c in range(NUM_CLASSES):
            n = len(cache.bmaxf[c])
            ub_c = np.zeros(n, np.float32)
            perm_c = np.zeros(n, np.int32)
            ubs_c = np.zeros(n, np.float32)
            if n > 1:
                f_ub = cache.bmaxf[c].astype(np.float32)
                dl_min = np.maximum(
                    cache.dl_min[c].astype(np.float32), 1.0
                )
                # unit-weight bounds through the SAME formula the device
                # uses (score_block), so host/device drift is ≤ ulp and
                # covered by the θ epsilon
                ub_c = score_block(
                    scorer, np.float32(1.0), f_ub, dl_min, self.avgdl,
                    xp=np,
                ).astype(np.float32)
                f_c = cache.f_c[c].astype(np.float32)
                dl_c = np.maximum(cache.dl_c[c].astype(np.float32), 1.0)
                f_m = cache.f_mdl[c].astype(np.float32)
                s_champ = score_block(
                    scorer, np.float32(1.0), f_c, dl_c, self.avgdl,
                    xp=np,
                ).astype(np.float32)
                s_lb = np.maximum(
                    s_champ,
                    score_block(
                        scorer, np.float32(1.0), f_m, dl_min, self.avgdl,
                        xp=np,
                    ),
                )
                if exact:
                    # zeroed (u16-overflow) or clipped champion pairs
                    # fall back to the loose bound — still sound
                    valid = (f_c > 0.0) & (f_c < 65535.0)
                    ub_c = np.where(valid, s_champ, ub_c)
                kk = min(K_MAX, ndrows)
                # vectorized per-span sort: [T, ndrows] argsort in one go
                tids = sorted(
                    t for t, (cc, _s) in cache.spans.items() if cc == c
                )
                if tids:
                    starts = np.asarray(
                        [cache.spans[t][1] for t in tids], np.int64
                    )
                    ix = starts[:, None] + np.arange(ndrows)[None, :]
                    u2 = ub_c[ix]  # [T, ndrows]
                    order = np.argsort(-u2, axis=1, kind="stable").astype(
                        np.int32
                    )
                    srt = np.take_along_axis(u2, order, axis=1)
                    perm_c.reshape(-1)[ix.reshape(-1)] = order.reshape(-1)
                    ubs_c.reshape(-1)[ix.reshape(-1)] = srt.reshape(-1)
                    l2 = s_lb[ix]
                    kk2 = min(kk, ndrows)
                    topv = -np.partition(-l2, kk2 - 1, axis=1)[:, :kk2]
                    topv = -np.sort(-topv, axis=1)
                    for j, t in enumerate(tids):
                        self.lb_top[t] = topv[j]
            self.ub.append(ub_c)
            self.perm.append(perm_c)
            self.ub_sorted.append(ubs_c)
            self.host_bytes += ub_c.nbytes + perm_c.nbytes + ubs_c.nbytes

    def theta(self, spans, k: int) -> float:
        """Lower bound of the k-th best score for these scored spans
        (w-weighted), 0.0 when unavailable."""
        th = 0.0
        for ds in spans:
            top = self.lb_top.get(ds.tid)
            if top is None or k > len(top):
                continue
            th = max(th, float(ds.w) * float(top[k - 1]))
        return th

    def survivors(self, spans, ws, theta_eps: float) -> np.ndarray:
        """Row offsets (0..ndrows-1) whose Σ_s w_s·ub_s ≥ theta_eps.

        Single span: O(log n) searchsorted over the precomputed
        ub-descending permutation. Multi span: vectorized row sum.
        """
        nd = self.cache.ndrows
        if len(spans) == 1:
            ds = spans[0]
            seg = slice(ds.start, ds.start + nd)
            sub = self.ub_sorted[ds.cls][seg]  # descending
            cut = np.float32(theta_eps / max(ws[0], 1e-30))
            cnt = int(np.searchsorted(-sub, -cut, side="right"))
            return self.perm[ds.cls][seg][:cnt].copy()
        acc = np.zeros(nd, np.float32)
        for ds, w in zip(spans, ws):
            seg = slice(ds.start, ds.start + nd)
            acc += np.float32(w) * self.ub[ds.cls][seg]
        return np.flatnonzero(acc >= np.float32(theta_eps)).astype(
            np.int32
        )


@dataclass(frozen=True)
class SkylineSpec:
    """Plan-time survivor-row schedule for one segment's dense spans."""

    field_name: str
    ndrows: int
    # per scored span: static class and dynamic (start, w)
    classes: Tuple[int, ...]
    starts: Tuple[int, ...]
    ws: Tuple[float, ...]
    # survivor row offsets within [0, ndrows), padded to M with IMAX
    row_ids: np.ndarray  # i32 [M]
    avgdl: float
    k: int
    conj: bool = False  # And tree: match = all spans hit (min-agg)
    # >= 2: min_match disjunction — match = (count of hitting spans) >= mm
    # (reference: min-match early pruning, disjunction.hpp:860-1100)
    min_match: int = 1

    def signature(self) -> tuple:
        return (
            self.field_name,
            self.classes,
            len(self.row_ids),
            self.ndrows,
            self.k,
            self.conj,
            self.min_match,
        )


def _scorer_supported(scorer: Scorer) -> bool:
    # BoostScore's ub is flat (every hit row ties) — no pruning power
    return isinstance(scorer, (BM25, TFIDF))


# candidate rows host-rescored exactly to derive the conjunctive θ
CONJ_THETA_SAMPLE = int(os.environ.get("IRS_SKYLINE_CONJ_SAMPLE", "512"))


def _host_conj_theta(ski, fp, spans, ws, rows, scorer, avgdl, k, mm=None) -> float:
    """k-th best EXACT conjunctive (or min_match ``mm``) score over the
    given grid rows, computed on host from the numpy grid pools (0.0 when
    < k matches).

    Every value returned is the score of a real all-hit (or >=mm-hit)
    doc, so it is a true lower bound of the k-th matching score — the
    And/MinMatch analog of the Or path's champion-pair lb_top (deletes
    are already zeroed out of the grid at cache build)."""
    from iresearch_tpu.formats.bitpack import unpack_blocks

    cache = ski.cache
    C = len(rows)
    if C == 0:
        return 0.0
    idx = rows[:, None].astype(np.int64) * BLOCK_L + np.arange(BLOCK_L)
    norms = fp.norms
    dl = np.ones((C, BLOCK_L), np.float32)
    valid = idx < len(norms)
    dl[valid] = np.maximum(norms[idx[valid]], 1).astype(np.float32)
    score = np.zeros((C, BLOCK_L), np.float32)
    fmin = None
    cnt = np.zeros((C, BLOCK_L), np.int32) if mm is not None else None
    for ds, w in zip(spans, ws):
        f = unpack_blocks(
            cache.pools[ds.cls][ds.start + rows], BITS[ds.cls]
        ).astype(np.float32)
        score += score_block(
            scorer, np.float32(w), f, dl, np.float32(avgdl), xp=np
        )
        if mm is not None:
            cnt += (f > 0.0).astype(np.int32)
        else:
            fmin = f if fmin is None else np.minimum(fmin, f)
    hits = score[cnt >= mm] if mm is not None else score[fmin > 0.0]
    if len(hits) < k:
        return 0.0
    return float(-np.partition(-hits, k - 1)[k - 1])


def skyline_shape(plan):
    """Tree shape eligible for skyline execution: "or" | "and" (from
    scan_shape) | int mm >= 2 (a min_match disjunction of all-dense
    leaves) | None.

    The mm case extends the reference's min-match early pruning
    (disjunction.hpp:860-1100) to the survivor-row tier: the fused scan
    cannot evaluate a count threshold, but the skyline gather rescores
    exact per-lane hit counts for free.
    """
    from iresearch_tpu.exec.executor import scan_shape

    shape = scan_shape(plan)
    if shape is not None:
        return shape
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
    t = plan.tree
    if (
        t[0] == "or"
        and not t[2]  # no Not children
        and t[4] == "sum"
        and int(t[3]) >= 2
        and all(c[0] == "leaf" for c in t[1])
        and sorted(c[1] for c in t[1]) == list(range(L))
        and [ds.leaf for ds in plan.dense_spans] == list(range(L))
    ):
        return int(t[3])
    return None


def skyline_spec(plan, sr, scorer: Scorer, k: int) -> Optional[SkylineSpec]:
    """Compute the survivor schedule for an eligible plan, else None.

    Eligibility: single-leaf disjunctive sum tree, all-leaf conjunctive
    sum tree, or min_match disjunction whose spans are all dense-grid
    resident in ONE field (skyline_shape), 1 ≤ k ≤ K_MAX, supported
    scorer, positive θ, strong enough pruning (the scan-ratio cost gate).
    Deletes are baked into the grid (formats/dense.py), so no gate here.
    """
    if not (1 <= k <= K_MAX) or not _scorer_supported(scorer):
        return None
    shape = skyline_shape(plan)
    if shape not in ("or", "and") and not isinstance(shape, int):
        return None
    spans = plan.dense_spans
    fields = {ds.field_name for ds in spans}
    if len(fields) != 1:
        return None
    fname = next(iter(fields))
    if any(ds.w < 0.0 for ds in spans):
        return None
    if shape == "or":
        # unscored (w=0) spans can only add score-0 matches, which a
        # positive θ already excludes from the top-k
        scored = [ds for ds in spans if ds.w > 0.0]
    else:
        # a conjunction's / min_match count's every span gates matches,
        # scored or not
        scored = list(spans)
    if not scored:
        return None
    # canonical span order: the sum over spans is order-free (device vs
    # oracle float-reorder is covered by the rtol gate), and sorting by
    # class merges e.g. (2,8) with (8,2) OrHighN queries into one batch
    # signature group instead of two
    scored.sort(key=lambda ds: (ds.cls, ds.start))
    ski = sr.skyline_index(fname, scorer, scored[0].avgdl)
    if ski is None:
        return None
    S = len(scored)
    ndrows = scored[0].ndrows
    ws = [float(ds.w) for ds in scored]
    if shape == "or":
        theta = ski.theta(scored, k)
        if not (theta > 0.0):
            return None
        # float-order guard: host θ vs device scores can differ by ulp
        theta_eps = theta * (1.0 - 1e-5) - 1e-30
        rows = ski.survivors(scored, ws, theta_eps)
    else:
        # candidate row mask: every span must hit the row (And), or at
        # least mm spans must (min_match) — a row can host a matching
        # doc only if enough spans have any hit in its 128-doc block
        mm = S if shape == "and" else min(int(shape), S + 1)
        hitcnt = np.zeros(ndrows, np.int32)
        acc = np.zeros(ndrows, np.float32)
        for ds, w in zip(scored, ws):
            seg = slice(ds.start, ds.start + ndrows)
            hitcnt += (ski.cache.bmaxf[ds.cls][seg] > 0).astype(np.int32)
            acc += np.float32(w) * ski.ub[ds.cls][seg]
        cand = np.flatnonzero(hitcnt >= mm).astype(np.int32)
        rows = cand
        if len(cand) > 4 * k:
            # θ from an exact host rescore of the top-C candidate rows
            C = min(len(cand), max(CONJ_THETA_SAMPLE, 4 * k))
            top = cand[np.argpartition(-acc[cand], C - 1)[:C]]
            theta = _host_conj_theta(
                ski, sr.data.fields[fname], scored, ws, top, scorer,
                scored[0].avgdl, k,
                mm=None if shape == "and" else mm,
            )
            if theta > 0.0:
                theta_eps = theta * (1.0 - 1e-5) - 1e-30
                rows = cand[acc[cand] >= np.float32(theta_eps)]
    M = min(_pow2(max(8, len(rows))), _pow2(ndrows))
    if len(rows) > SKYLINE_MAX_ROWS or M * SKYLINE_SCAN_RATIO > S * ndrows:
        return None
    padded = np.full(M, _IMAX32, np.int32)
    padded[: len(rows)] = rows
    return SkylineSpec(
        field_name=fname,
        ndrows=ndrows,
        classes=tuple(ds.cls for ds in scored),
        starts=tuple(ds.start for ds in scored),
        ws=tuple(ws),
        row_ids=padded,
        avgdl=float(scored[0].avgdl),
        k=k,
        conj=shape == "and",
        min_match=1 if shape in ("or", "and") else int(shape),
    )


def skyline_topk(
    span_pools,  # per span: u32 [rows_c, wpb] dense grid pool (shared ok)
    norms_grid,  # [ndrows, 128] u16/f32 doc lengths
    row_ids,  # i32 [M] survivor rows, IMAX-padded (traced)
    starts,  # i32 per span (traced)
    ws,  # f32 per span (traced)
    avgdl,  # f32 (traced)
    *,
    scorer: Scorer,
    span_bits: Tuple[int, ...],
    k: int,
    ndrows: int,
    conj: bool = False,
    mm: int = 1,
):
    """Exact (vals f32 [k], docs i32 [k]) over the survivor rows only."""
    import jax.numpy as jnp

    from iresearch_tpu.formats.bitpack import unpack_jnp
    from iresearch_tpu.formats.spec import BLOCK

    S = len(span_pools)
    IMAX = jnp.int32(_IMAX32)
    parked = row_ids >= ndrows
    safe = jnp.where(parked, 0, row_ids)
    dl = norms_grid[safe]
    if not jnp.issubdtype(dl.dtype, jnp.floating):
        dl = dl.astype(jnp.int32).astype(jnp.float32)
    dl = jnp.maximum(dl, 1.0)
    M = row_ids.shape[0]
    score = jnp.zeros((M, BLOCK), jnp.float32)
    fagg = None
    for s in range(S):
        # parked rows read the class pool's global zero sentinel (row 0)
        rows_abs = jnp.where(parked, 0, starts[s] + safe)
        f = unpack_jnp(span_pools[s][rows_abs], span_bits[s]).astype(
            jnp.int32
        ).astype(jnp.float32)
        score = score + score_block(scorer, ws[s], f, dl, avgdl, xp=jnp)
        if mm > 1:  # per-lane hit count for the min_match threshold
            c = (f > 0.0).astype(jnp.int32)
            fagg = c if fagg is None else fagg + c
        else:
            fagg = f if fagg is None else (
                jnp.minimum(fagg, f) if conj else fagg + f
            )
    lane = jnp.arange(BLOCK, dtype=jnp.int32)
    hit = fagg >= mm if mm > 1 else fagg > 0.0
    match = hit & (~parked)[:, None]
    docs = jnp.where(
        match, safe[:, None] * BLOCK + lane[None, :], IMAX
    )
    masked = jnp.where(match, score, _NEG_INF)
    from iresearch_tpu.exec.candidates import topk_docs

    return topk_docs(masked.reshape(-1), docs.reshape(-1), k)


def skyline_topk_batch(
    span_pools,  # per span: u32 [rows_c, wpb] dense grid pool (shared)
    norms_grid,  # [ndrows, 128] u16/f32 doc lengths (shared)
    rows_b,  # i32 [Q, M] survivor rows, IMAX-padded
    starts_b,  # i32 [Q, S]
    ws_b,  # f32 [Q, S]
    avgdl,  # f32
    *,
    scorer: Scorer,
    span_bits: Tuple[int, ...],
    k: int,
    ndrows: int,
    conj: bool = False,
    mm: int = 1,
):
    """Batched skyline_topk: per-query (vals [Q, k], docs [Q, k]).

    The row gathers use ONE flat [Q*M] 1-D index per operand — XLA's
    fast row-copy lowering. vmapping
    skyline_topk instead produces 2-D [Q, M] gather indices, which lower
    to ~8 ns/element scalar gathers (measured 0.9 ms/query at M=8192).
    Only the final per-query top-k is vmapped."""
    import jax.numpy as jnp

    from iresearch_tpu.formats.bitpack import unpack_jnp
    from iresearch_tpu.formats.spec import BLOCK
    from iresearch_tpu.exec.candidates import topk_docs

    S = len(span_pools)
    Q, M = rows_b.shape
    IMAX = jnp.int32(_IMAX32)
    parked = rows_b >= ndrows  # [Q, M]
    safe = jnp.where(parked, 0, rows_b)
    dl = norms_grid[safe.reshape(-1)].reshape(Q, M, BLOCK)
    if not jnp.issubdtype(dl.dtype, jnp.floating):
        dl = dl.astype(jnp.int32).astype(jnp.float32)
    dl = jnp.maximum(dl, 1.0)
    score = jnp.zeros((Q, M, BLOCK), jnp.float32)
    fagg = None
    for s in range(S):
        rows_abs = jnp.where(parked, 0, starts_b[:, s : s + 1] + safe)
        f = unpack_jnp(
            span_pools[s][rows_abs.reshape(-1)], span_bits[s]
        ).reshape(Q, M, BLOCK).astype(jnp.int32).astype(jnp.float32)
        score = score + score_block(
            scorer, ws_b[:, s, None, None], f, dl, avgdl, xp=jnp
        )
        if mm > 1:  # per-lane hit count for the min_match threshold
            c = (f > 0.0).astype(jnp.int32)
            fagg = c if fagg is None else fagg + c
        else:
            fagg = f if fagg is None else (
                jnp.minimum(fagg, f) if conj else fagg + f
            )
    lane = jnp.arange(BLOCK, dtype=jnp.int32)
    hit = fagg >= mm if mm > 1 else fagg > 0.0
    match = hit & (~parked)[:, :, None]
    docs = jnp.where(
        match, safe[:, :, None] * BLOCK + lane[None, None, :], IMAX
    )
    masked = jnp.where(match, score, _NEG_INF)
    import jax

    return jax.vmap(lambda v, d: topk_docs(v, d, k))(
        masked.reshape(Q, -1), docs.reshape(Q, -1)
    )
