"""Segment-sharded query execution over a jax.sharding.Mesh.

Layout: all per-segment arrays are stacked with a leading segment axis
``[S, ...]`` (S padded to a multiple of the mesh size with empty segments)
and sharded along the mesh's only axis. One jitted shard_map program per
plan signature runs the shared dense segment body (exec/executor.py:
segment_body) on each local segment, takes a local top-k, converts to
global doc ids, and merges across the mesh with ``all_gather`` over ICI +
a lexicographic (-score, doc) re-rank — bitwise-identical ranking on every
shard, so exact top-k is preserved under sharding (SURVEY.md §7 "hard
parts": float-order control via fixed merge order + doc-id tie-break).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import numpy as np

from iresearch_tpu.exec.executor import _NEG_INF, segment_body, wand_body
from iresearch_tpu.exec.plan import PlanCompiler, SegmentPlan
from iresearch_tpu.formats.bitpack import BITS, words_per_block
from iresearch_tpu.formats.spec import NUM_CLASSES
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.host_eval import HostQuery
from iresearch_tpu.search.scorers import BM25, Scorer

AXIS = "d"
_IMAX32 = 2**31 - 1


def make_mesh(devices=None, axis: str = AXIS):
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class ShardedSearcher:
    """Shards a reader's segments across a 1-D mesh and runs exact top-k.

    Building the searcher uploads the stacked pools once with a
    NamedSharding along the mesh axis (the device_put analog of the
    reference's per-segment mmap warmup).
    """

    def __init__(self, segments: Sequence, mesh=None) -> None:
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = AXIS
        self.D = self.mesh.devices.size
        # multi-host (DCN) mesh: some mesh devices belong to other
        # processes — host arrays then enter via make_array_from_callback
        # (each process contributes its addressable shards) and replicated
        # jit inputs must be explicitly placed (see prepare_many)
        self._multiproc = any(
            d.process_index != jax.process_index()
            for d in self.mesh.devices.flat
        )
        self.segments = list(segments)
        S = max(1, math.ceil(len(self.segments) / self.D) * self.D)
        self.S = S
        self.per_shard = S // self.D
        self.nd_pad = max(
            [_pow2(max(1, sr.num_docs)) for sr in self.segments] or [1]
        )
        self._doc_base = np.zeros(S, np.int32)
        base = 0
        for i, sr in enumerate(self.segments):
            self._doc_base[i] = base
            base += sr.num_docs
        self.total_docs = base
        self._field_pool_cache: Dict[str, tuple] = {}
        self._alive = self._stack_alive()
        self._dense_layouts: Dict[str, object] = {}
        self._dense_pool_cache: Dict[Tuple[str, int], object] = {}

    # --- stacked device residency ---------------------------------------

    def _put(self, arr: np.ndarray, spec_dims: int):
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = P(self.axis, *([None] * (spec_dims - 1)))
        sharding = NamedSharding(self.mesh, spec)
        if self._multiproc:
            # multi-host mesh (DCN): every process holds the full host
            # array (the index build is deterministic and replayed per
            # process); each contributes only its ADDRESSABLE shards —
            # device_put to a cross-process sharding is not allowed
            arr = np.asarray(arr)
            return jax.make_array_from_callback(
                arr.shape, sharding, lambda idx: arr[idx]
            )
        return jax.device_put(arr, sharding)

    def _put_rep(self, arr: np.ndarray):
        """Replicate an array on every mesh device (no shard axis)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(self.mesh, P())
        if self._multiproc:
            arr = np.asarray(arr)
            return jax.make_array_from_callback(
                arr.shape, sharding, lambda idx: arr[idx]
            )
        return jax.device_put(arr, sharding)

    def _stack_alive(self):
        alive = np.zeros((self.S, self.nd_pad), np.bool_)
        for i, sr in enumerate(self.segments):
            alive[i, : sr.num_docs] = sr.alive
        return self._put(alive, 2)

    def _field_pools(self, fname: str):
        """Stacked per-class pools for one field: ([(doc_words, base)],
        [(freq_words,)], [(nrm_words,)], norms)."""
        cached = self._field_pool_cache.get(fname)
        if cached is not None:
            return cached

        def stack(attr, extra=None):
            per_class = []
            for c in range(NUM_CLASSES):
                rmax = 1
                for sr in self.segments:
                    fp = sr.field(fname)
                    if fp is not None and getattr(fp, attr) is not None:
                        rmax = max(rmax, getattr(fp, attr)[c].shape[0])
                rmax = _pow2(rmax)
                words = np.zeros(
                    (self.S, rmax, words_per_block(BITS[c])), np.uint32
                )
                extra_arr = np.zeros((self.S, rmax), np.int32)
                for i, sr in enumerate(self.segments):
                    fp = sr.field(fname)
                    if fp is None or getattr(fp, attr) is None:
                        continue
                    src = getattr(fp, attr)[c]
                    words[i, : src.shape[0]] = src
                    if extra is not None:
                        e = getattr(fp, extra)[c]
                        extra_arr[i, : len(e)] = e.astype(np.int32)
                if extra is not None:
                    per_class.append((self._put(words, 3), self._put(extra_arr, 2)))
                else:
                    per_class.append((self._put(words, 3),))
            return per_class

        doc_cls = stack("doc_words", "base")
        freq_cls = stack("freq_words")
        nrm_cls = stack("nrm_words")  # zeros for legacy segments (bn=-1)
        norms = np.ones((self.S, self.nd_pad), np.float32)
        for i, sr in enumerate(self.segments):
            fp = sr.field(fname)
            if fp is not None:
                norms[i, : len(fp.norms)] = np.maximum(fp.norms, 1)
        out = (doc_cls, freq_cls, nrm_cls, self._put(norms, 2))
        self._field_pool_cache[fname] = out
        return out

    # --- uniform cross-shard dense layout --------------------------------

    def _dense_layout(self, fname: str):
        lay = self._dense_layouts.get(fname)
        if lay is None:
            from iresearch_tpu.parallel.dense_stack import UniformDenseLayout

            lay = UniformDenseLayout(self.segments, fname, self.nd_pad)
            self._dense_layouts[fname] = lay
        return lay

    def _dense_pool(self, fname: str, cls: int):
        key = (fname, cls)
        cached = self._dense_pool_cache.get(key)
        if cached is None:
            cached = self._put(self._dense_layout(fname).pools_np[cls], 3)
            self._dense_pool_cache[key] = cached
        return cached

    def _wrapped_segments(self):
        from iresearch_tpu.parallel.dense_stack import wrap_segments

        class _LazyLayouts(dict):
            def __init__(inner, outer):
                super().__init__()
                inner._outer = outer

            def get(inner, fname, default=None):
                lay = dict.get(inner, fname)
                if lay is None:
                    lay = inner._outer._dense_layout(fname)
                    inner[fname] = lay
                return lay

        return wrap_segments(self.segments, _LazyLayouts(self))

    # --- query ----------------------------------------------------------

    def prepare_many(
        self,
        filters: Sequence[F.Filter],
        scorer: Optional[Scorer] = None,
        wand: bool = False,
        wand_sample: int = 16,
        k_max: int = 128,
    ) -> "PreparedShardedBatch":
        """Batched + WAND sharded prepare (SURVEY §2.11 items 1+2).

        Queries are grouped by plan signature and stacked on a leading Q
        axis per signature group; each group runs as ONE shard_map
        dispatch (vmapped over Q inside every shard). High-df terms
        execute from the uniform cross-shard dense-grid layout
        (parallel/dense_stack.py), so the dense/gridmix/join tiers run
        under shard_map with the same machinery as the single-chip path.
        Tier selection is made uniform across shards per query; tiers
        whose per-shard structure diverges (e.g. join span splits) are
        re-pinned to the sort tier — exact for any covering aux-free
        tree. Per-shard WAND θ stays a valid lower bound, so pruning is
        exact under sharding. ``k_max``: largest top-k this prepare may
        serve (bounds the scored-only multiterm optimization; run(k)
        rejects k beyond it).
        """
        import jax.numpy as jnp

        scorer = scorer or BM25()
        S = len(self.segments)
        wsegs = self._wrapped_segments()
        per_query = []  # (plans, mode, use_wand)
        self_kmax = None
        for flt in filters:
            prepared = HostQuery(flt, wsegs, scorer)
            compiler = PlanCompiler(prepared, scorer)

            def compile_all(device_phrase="keys", **kw):
                plans = [
                    compiler.compile(
                        flt, s, wand=wand, device_phrase=device_phrase, **kw
                    )
                    for s in range(S)
                ]
                # scored-only plans are exact only for k <= kmax; honor
                # the caller's k_max by recompiling exhaustively
                for s, p in enumerate(plans):
                    if 0 < p.scored_only_kmax < k_max:
                        plans[s] = compiler.compile(
                            flt, s, wand=wand, device_phrase=device_phrase,
                            scored_only=False, **kw,
                        )
                return plans

            dp = "keys"
            plans = compile_all(device_phrase=dp, dense=True)
            # device-phrase keys (exec/phrase.py:PhraseKeysSpec) need a
            # shard-invariant structure: same aux slots, same part
            # counts, and i32 key headroom. Otherwise host-eval the aux.
            ph_struct = {
                tuple(
                    (ai, len(spec.part_keys64))
                    for ai, spec in p.device_aux
                )
                for p in plans
            }
            caplog = 0
            if len(ph_struct) != 1:
                dp = False
                plans = compile_all(device_phrase=dp, dense=True)
            elif next(iter(ph_struct)):
                max_pos = max(
                    (
                        spec.max_pos
                        for p in plans
                        for _ai, spec in p.device_aux
                    ),
                    default=0,
                )
                caplog = max(1, int(max_pos).bit_length())
                if self.nd_pad << caplog >= 2**31:
                    dp = False
                    caplog = 0
                    plans = compile_all(device_phrase=dp, dense=True)
            for p in plans:
                if p.scored_only_kmax > 0:
                    self_kmax = min(
                        self_kmax or p.scored_only_kmax, p.scored_only_kmax
                    )
            active = [p for p in plans if p.groups or p.dense_spans]
            # dslice (contiguous-slice decode) shares the direct tier's
            # rowset structure; the sharded executor runs it as "direct"
            _norm = lambda m: "direct" if m == "dslice" else m  # noqa: E731
            modes = {_norm(p.exec_mode) for p in active}
            mode = None
            if len(modes) == 1:
                m = next(iter(modes))
                if m == "join":
                    # join splits groups per span (segment-dependent key
                    # structure) — not stackable across shards; the repin
                    # below picks dense (grid spans present) or sort
                    mode = None
                elif m == "gridmix":
                    sigs = {
                        (
                            len(p.groups),
                            tuple(int(g.leaf[0]) for g in p.groups),
                        )
                        for p in active
                    }
                    if len(sigs) == 1:
                        mode = "gridmix"
                else:
                    mode = m
            if mode is None:
                # divergent tiers: re-pin. Dense-fold is universal; sort
                # needs a covering aux-free tree.
                if not active:
                    mode = "dense"
                    plans = compile_all(device_phrase=dp, modes=False, dense=True)
                elif any(_norm(p.exec_mode) == "dense" for p in active) or any(
                    p.dense_spans for p in plans
                ):
                    mode = "dense"
                    plans = compile_all(device_phrase=dp, modes=False, dense=True)
                else:
                    mode = "sort"
                    plans = compile_all(device_phrase=dp, force_mode="sort", dense=False)
                    if any(
                        p.exec_mode != "sort" for p in plans if p.groups
                    ):
                        mode = "dense"  # force_mode fell back (non-covering)
                        plans = compile_all(device_phrase=dp, modes=False, dense=True)
            use_wand = (
                wand
                and any(p.groups or p.dense_spans for p in plans)
                and all(g.ub is not None for p in plans for g in p.groups)
                and all(
                    d.ub is not None for p in plans for d in p.dense_spans
                )
                # wand plumbing exists for the fold tiers only (plan.py
                # disables ub emission for join/gridmix anyway)
                and mode in ("dense", "direct", "sort")
            )
            # union of dense spans across shards, aligned by the
            # shard-invariant (leaf, field, class, ndrows, start) identity
            # (starts are term-keyed and uniform — dense_stack.py); a
            # shard lacking the term reads its zero rows at the same
            # start, an exact no-op
            uspans: Dict[tuple, dict] = {}
            for si, p in enumerate(plans):
                for d in p.dense_spans:
                    key = (d.leaf, d.field_name, d.cls, d.ndrows, d.start)
                    ent = uspans.get(key)
                    if ent is None:
                        ent = uspans[key] = {
                            "w": {}, "avgdl": d.avgdl, "ub": {},
                        }
                    # w is per SHARD: multiterm sampling scores only the
                    # sampled (segment, term) visits (w=0 elsewhere)
                    ent["w"][si] = d.w
                    if d.ub is not None:
                        ent["ub"][si] = d.ub
            uordered = [
                (k[0], k[1], k[2], k[3], k[4], v["w"], v["avgdl"], v["ub"])
                for k, v in sorted(uspans.items())
            ]
            # phrase-keys aux: per aux slot, the per-shard specs (same
            # structure across shards — checked above)
            phspecs = []
            if dp == "keys" and plans[0].device_aux:
                for pi, (ai, _spec0) in enumerate(plans[0].device_aux):
                    phspecs.append(
                        (ai, [p.device_aux[pi][1] for p in plans])
                    )
            per_query.append((plans, mode, use_wand, uordered, phspecs, caplog))
        self._last_kmax = self_kmax  # None = exhaustive for any k

        groups_by_sig: Dict[tuple, List[int]] = {}
        for qi, (plans, mode, use_wand, uordered, phspecs, caplog) in enumerate(
            per_query
        ):
            p0 = plans[0]
            qkeys = tuple(sorted({
                (g.field_name, g.dcls, g.fcls, g.ncls)
                for p in plans
                for g in p.groups
            }))
            # dense structure: per-span static geometry, start excluded
            # (dynamic, stacked along Q)
            dkeys = tuple((u[0], u[1], u[2], u[3]) for u in uordered)
            A = max(
                [0] + [
                    0 if p.aux_pairs is None else len(p.aux_pairs)
                    for p in plans
                ]
            )
            rmax = {}
            for p in plans:
                for g in p.groups:
                    kk = (g.field_name, g.dcls, g.fcls, g.ncls)
                    rmax[kk] = max(rmax.get(kk, 8), len(g.rows_d))
            # phrase static structure: (aux_idx, nparts, key buckets,
            # caplog, score-field) per aux slot
            pkeys_sig = tuple(
                (
                    ai,
                    len(specs[0].part_keys64),
                    tuple(
                        _pow2(
                            max(
                                [8]
                                + [len(sp.part_keys64[m]) for sp in specs]
                            )
                        )
                        for m in range(len(specs[0].part_keys64))
                    ),
                    caplog,
                    specs[0].field_name,
                )
                for ai, specs in phspecs
            )
            sig = (
                p0.tree, p0.num_leaves, mode, use_wand, qkeys, A,
                tuple(_pow2(rmax[kk]) for kk in qkeys),
                dkeys,
                pkeys_sig,
            )
            groups_by_sig.setdefault(sig, []).append(qi)

        calls = []
        for sig, qis in groups_by_sig.items():
            tree, num_leaves, mode, use_wand, qkeys, A, Rs, dkeys, \
                pkeys_sig = sig
            # θ pruning is useless when the sampled phase already decodes
            # every row (same rule as exec/batch.py); dense spans keep it
            # (rows per span = ndrows >> sample)
            use_wand = use_wand and (
                max(Rs, default=0) > wand_sample or bool(dkeys)
            )
            Q = len(qis)
            G = len(qkeys)
            pools_st = []
            rowsets_st = []
            gbits = []
            avgdl = np.ones(max(G, 1), np.float32)
            gleaf = [0] * max(G, 1)
            for gi, (fname, dcls, fcls, ncls) in enumerate(qkeys):
                doc_cls, freq_cls, nrm_cls, norms = self._field_pools(fname)
                doc_words, base = doc_cls[dcls]
                (freq_words,) = freq_cls[fcls]
                (nrm_words,) = nrm_cls[ncls] if ncls >= 0 else freq_cls[fcls]
                pools_st.append(
                    (doc_words, freq_words, nrm_words, base, norms)
                )
                gbits.append(
                    (BITS[dcls], BITS[fcls], BITS[ncls] if ncls >= 0 else -1)
                )
                R = Rs[gi]
                rows_d = np.zeros((self.S, Q, R), np.int32)
                rows_f = np.zeros((self.S, Q, R), np.int32)
                rows_n = np.zeros((self.S, Q, R), np.int32)
                w = np.zeros((self.S, Q, R), np.float32)
                leaf = np.zeros((self.S, Q, R), np.int32)
                ub = (
                    np.full((self.S, Q, R), -np.inf, np.float32)
                    if use_wand else None
                )
                other = np.zeros((self.S, Q, R), np.float32) if use_wand else None
                for j, qi in enumerate(qis):
                    plans = per_query[qi][0]
                    for i, p in enumerate(plans):
                        for gi2, g in enumerate(p.groups):
                            if (g.field_name, g.dcls, g.fcls, g.ncls) != (
                                fname, dcls, fcls, ncls,
                            ):
                                continue
                            rows_d[i, j, : len(g.rows_d)] = g.rows_d
                            rows_f[i, j, : len(g.rows_f)] = g.rows_f
                            rows_n[i, j, : len(g.rows_n)] = g.rows_n
                            w[i, j, : len(g.weight)] = g.weight
                            leaf[i, j, : len(g.leaf)] = g.leaf
                            avgdl[gi] = p.group_avgdl[gi2]
                            gleaf[gi] = int(g.leaf[0])
                            if use_wand:
                                ub[i, j, : len(g.ub)] = g.ub
                                other[i, j, : len(g.other)] = g.other
                rowset = (
                    self._put(rows_d, 3),
                    self._put(rows_f, 3),
                    self._put(rows_n, 3),
                    self._put(w, 3),
                    self._put(leaf, 3),
                )
                if use_wand:
                    rowset = rowset + (self._put(ub, 3), self._put(other, 3))
                rowsets_st.append(rowset)

            leaf_min_b = np.stack(
                [per_query[qi][0][0].leaf_min_match for qi in qis]
            )
            # dense-grid spans from the uniform layout: pools shared per
            # (field, class); starts/weights stack along Q (uniform across
            # shards); WAND bounds stack along (S, Q) — per shard
            dense_shared = []
            dense_dyn = []
            dense_static = []
            for di, (dleaf, fname, cls, ndrows) in enumerate(dkeys):
                _dc, _fc, _nc, fnorms = self._field_pools(fname)
                starts = np.zeros(Q, np.int32)
                ws = np.zeros((self.S, Q), np.float32)
                davg = 1.0
                ub = (
                    np.full((self.S, Q, ndrows), -np.inf, np.float32)
                    if use_wand else None
                )
                other = (
                    np.zeros((self.S, Q), np.float32) if use_wand else None
                )
                for j, qi in enumerate(qis):
                    u = per_query[qi][3][di]
                    starts[j] = u[4]
                    for si, w_s in u[5].items():
                        ws[si, j] = w_s
                    davg = u[6]
                    if use_wand:
                        for si, ub_s in u[7].items():
                            ub[si, j, : len(ub_s)] = ub_s
                        plans = per_query[qi][0]
                        for si, p in enumerate(plans):
                            for d in p.dense_spans:
                                if (d.leaf, d.field_name, d.cls, d.ndrows,
                                        d.start) == (dleaf, fname, cls,
                                                     ndrows, u[4]):
                                    other[si, j] = d.other
                dense_shared.append(
                    (self._dense_pool(fname, cls), fnorms,
                     np.float32(davg))
                )
                dyn = (self._put_rep(starts), self._put(ws, 2))
                if use_wand:
                    dyn = dyn + (self._put(ub, 3), self._put(other, 2))
                dense_dyn.append(dyn)
                dense_static.append((BITS[cls], dleaf, ndrows, True))
            if A:
                # scatter the sparse per-plan pairs into the stacked
                # shard_map input (dense [S,Q,A,nd] is the stacking
                # format; the pairs keep per-plan host churn O(matches))
                am = np.zeros((self.S, Q, A, self.nd_pad), np.bool_)
                asc = np.zeros((self.S, Q, A, self.nd_pad), np.float32)
                for j, qi in enumerate(qis):
                    for i, p in enumerate(per_query[qi][0]):
                        if p.aux_pairs is not None:
                            for a, (da, va) in enumerate(p.aux_pairs):
                                am[i, j, a, da] = True
                                asc[i, j, a, da] = va
            else:  # unused dummies keep the shard_map arg structure static
                am = np.zeros((self.S, 1, 1, 1), np.bool_)
                asc = np.zeros((self.S, 1, 1, 1), np.float32)
            # phrase-keys aux: per aux slot, per-part i32 key arrays
            # [S, Q, NK] (IMAX-padded), per-shard weights, score-field
            # norms; intersection runs in the shard_map kernel
            phrase_args = []
            phrase_static = []
            for pi, (ai, nparts, buckets, caplog_a, fld) in enumerate(
                pkeys_sig
            ):
                _d2, _f2, _n2, pnorms = self._field_pools(fld)
                keys_parts = []
                for m in range(nparts):
                    NK = buckets[m]
                    karr = np.full((self.S, Q, NK), _IMAX32, np.int32)
                    for j, qi in enumerate(qis):
                        specs = per_query[qi][4][pi][1]
                        for si, sp in enumerate(specs):
                            k64 = sp.part_keys64[m]
                            if len(k64):
                                k32 = ((k64 >> 32) << caplog_a) | (
                                    k64 & 0xFFFFFFFF
                                )
                                karr[si, j, : len(k64)] = k32.astype(
                                    np.int32
                                )
                    keys_parts.append(self._put(karr, 3))
                w_arr = np.zeros((self.S, Q), np.float32)
                pavg = 1.0
                for j, qi in enumerate(qis):
                    specs = per_query[qi][4][pi][1]
                    for si, sp in enumerate(specs):
                        w_arr[si, j] = sp.weight
                        pavg = sp.avgdl
                phrase_args.append(
                    (
                        tuple(keys_parts),
                        self._put(w_arr, 2),
                        pnorms,
                        np.float32(pavg),
                    )
                )
                phrase_static.append((ai, nparts, caplog_a))
            driver_gi = -1
            group_leaf = tuple(gleaf[:G])
            lanes = (sum(Rs) if mode != "dense" else 0) * 128
            calls.append((
                qis,
                (
                    tuple(pools_st),
                    tuple(rowsets_st),
                    self._put_rep(avgdl),
                    self._put_rep(leaf_min_b),
                    self._put(am, 4),
                    self._put(asc, 4),
                    self._alive,
                    self._put(self._doc_base, 1),
                    tuple(dense_shared),
                    tuple(dense_dyn),
                    tuple(phrase_args),
                ),
                dict(
                    mesh=self.mesh,
                    tree=tree,
                    gbits=tuple(gbits),
                    scorer=scorer,
                    num_leaves=num_leaves,
                    nd=self.nd_pad,
                    per_shard=self.per_shard,
                    mode=mode,
                    use_wand=use_wand,
                    sample=wand_sample,
                    has_aux=bool(A),
                    dense_static=tuple(dense_static),
                    driver_gi=driver_gi,
                    group_leaf=group_leaf,
                    phrase_static=tuple(phrase_static),
                ),
                (
                    lanes
                    if mode in ("direct", "sort", "join") and not dkeys
                    else self.nd_pad
                ),
            ))
        return PreparedShardedBatch(self, calls, kmax=self_kmax)

    def search(
        self, flt: F.Filter, scorer: Optional[Scorer] = None, k: int = 10
    ) -> List[Tuple[int, float]]:
        vals, docs = self.search_arrays(flt, scorer, k)
        out = []
        for v, d in zip(np.asarray(vals), np.asarray(docs)):
            if math.isinf(v) and v < 0:
                continue
            out.append((int(d), float(v)))
        return out

    def search_arrays(self, flt: F.Filter, scorer: Optional[Scorer], k: int):
        return self.prepare(flt, scorer).run(k)

    def prepare(
        self,
        flt: F.Filter,
        scorer: Optional[Scorer] = None,
        wand: bool = False,
        k_max: int = 128,
    ) -> "PreparedShardedQuery":
        """Compile + upload once; the returned query re-runs dispatch-only
        (reference analog: filter::prepare caching per-segment state).

        Routes through the SAME machinery as prepare_many with Q=1
        (VERDICT r3 item 4): prepared single queries get the dense-grid /
        gridmix / sort tiers and uniform cross-shard layout instead of
        the O(nd)-fold special case. ``k_max`` bounds scored-only
        multiterm plans (run(k) rejects k beyond it)."""
        return PreparedShardedQuery(
            self.prepare_many([flt], scorer, wand=wand, k_max=k_max)
        )


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "tree", "gbits", "scorer", "num_leaves", "k", "nd",
        "per_shard", "mode", "use_wand", "sample", "has_aux",
        "dense_static", "driver_gi", "group_leaf", "phrase_static",
    ),
)
def _sharded_topk_batch(
    pools_st,  # per group: (doc_words, freq_words, nrm_words, base, norms), each [S, ...]
    rowsets_st,  # per group: (rows_d, rows_f, rows_n, w, leaf[, ub, other]) each [S, Q, R]
    avgdl,  # f32 [G] (replicated)
    leaf_min_b,  # i32 [Q, L] (replicated)
    aux_match,  # bool [S, Q, A, nd] or None
    aux_score,  # f32 [S, Q, A, nd] or None
    alive_st,  # bool [S, nd]
    doc_base,  # i32 [S]
    dense_shared=(),  # per dense span: (pool [S,rows,wpb], norms [S,nd], avgdl)
    dense_dyn=(),  # per span: (starts [Q], ws [S,Q][, ub [S,Q,ndrows], other [S,Q]])
    phrase_args=(),  # per phrase aux: (keys per part [S,Q,NK], w [S,Q], norms [S,nd], avgdl)
    *,
    mesh,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    k: int,
    nd: int,
    per_shard: int,
    mode: str,  # "dense" | "direct" | "sort" | "gridmix" (uniform)
    use_wand: bool,
    sample: int,
    has_aux: bool,
    dense_static=(),  # per span: (bits, leaf, ndrows, same_dl)
    driver_gi: int = -1,
    group_leaf: tuple = (),
    phrase_static=(),  # per phrase aux: (aux_idx, nparts, caplog)
):
    """Batched sharded execution: SURVEY §2.11 items 1+2 combined — many
    queries stacked on a leading Q axis, vmapped through the shared
    executor bodies per local segment, per-shard top-k, then an exact ICI
    all_gather merge with (-score, doc) re-rank. High-df terms stream
    from the stacked uniform dense-grid pools (parallel/dense_stack.py).
    Per-shard WAND θ is exact: θ is a lower bound of the global k-th
    score computed from local blocks, so pruning never drops a true
    top-k block."""
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from iresearch_tpu.exec.candidates import candidate_body

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def local(pools_l, rowsets_l, aux_m_l, aux_s_l, alive_l, base_l,
              dshared_l, ddyn_l, ph_l):
        vals_l = []
        docs_l = []
        for s in range(per_shard):
            pools_s = tuple(tuple(a[s] for a in pool) for pool in pools_l)
            rowsets_sq = tuple(tuple(r[s] for r in rs) for rs in rowsets_l)
            alive_s = alive_l[s]
            # dense spans: shard-local pool/norms; per-query dyn below
            dpool_s = tuple(
                (sh[0][s], sh[1][s], sh[2]) for sh in dshared_l
            )
            ddyn_sq = tuple(
                (dd[0],) + tuple(x[s] for x in dd[1:]) for dd in ddyn_l
            )
            # phrase aux: per-q (keys per part [Q,NK], w [Q]); per-shard
            # constants (norms [nd], avgdl) closed over
            ph_sq = tuple(
                (tuple(kp[s] for kp in pa[0]), pa[1][s])
                for pa in ph_l
            )
            ph_const = tuple((pa[2][s], pa[3]) for pa in ph_l)

            def one(rowsets_q, leaf_min, ddyn_q, ph_q=(),
                    aux_m=None, aux_s=None):
                dense_args = tuple(
                    (sh[0], dq[0], dq[1], sh[1], sh[2]) + tuple(dq[2:])
                    for sh, dq in zip(dpool_s, ddyn_q)
                )
                # device phrase: sorted-key intersection per aux slot
                # (exec/phrase.py semantics, host_eval._eval_positional
                # formulation) — results overwrite the aux zeros
                for (keys_q, w_q), (pnorms_s, pavg), (aux_idx, nparts,
                        caplog) in zip(ph_q, ph_const, phrase_static):
                    from iresearch_tpu.search.scorers import score_block

                    k0 = keys_q[0]
                    alive_k = k0 != jnp.int32(_IMAX32)
                    for m in range(1, nparts):
                        km = keys_q[m]
                        ix = jnp.searchsorted(km, k0)
                        found = (
                            km[jnp.minimum(ix, km.shape[0] - 1)] == k0
                        )
                        alive_k = alive_k & found
                    pdocs = (k0 >> caplog).astype(jnp.int32)
                    tf = (
                        jnp.zeros(nd, jnp.float32)
                        .at[jnp.where(alive_k, pdocs, nd - 1)]
                        .add(
                            jnp.where(alive_k, 1.0, 0.0), mode="drop"
                        )
                    )
                    pm = tf > 0
                    sc = score_block(
                        scorer,
                        w_q,
                        tf.reshape(1, -1),
                        jnp.maximum(
                            pnorms_s.astype(jnp.float32), 1.0
                        ).reshape(1, -1),
                        pavg,
                        xp=jnp,
                    ).reshape(-1)
                    aux_m = aux_m.at[aux_idx].set(pm)
                    aux_s = aux_s.at[aux_idx].set(jnp.where(pm, sc, 0.0))
                if mode != "dense":
                    return candidate_body(
                        pools_s, rowsets_q, avgdl, leaf_min, alive_s, None,
                        tree=tree, gbits=gbits, scorer=scorer,
                        num_leaves=num_leaves, k=k, mode=mode,
                        driver_gi=driver_gi, group_leaf=group_leaf,
                        wand=use_wand, sample=sample, nd=nd,
                        dense_args=dense_args, dense_static=dense_static,
                    )
                if use_wand:
                    return wand_body(
                        pools_s, rowsets_q, avgdl, leaf_min, alive_s,
                        tree=tree, gbits=gbits, scorer=scorer,
                        num_leaves=num_leaves, k=k, nd=nd, sample=sample,
                        dense_args=dense_args, dense_static=dense_static,
                    )
                match, score = segment_body(
                    pools_s, rowsets_q, avgdl, leaf_min, aux_m, aux_s,
                    alive_s, tree=tree, gbits=gbits, scorer=scorer,
                    num_leaves=num_leaves, nd=nd,
                    dense_args=dense_args, dense_static=dense_static,
                )
                from iresearch_tpu.ops.topk import wide_top_k

                return wide_top_k(jnp.where(match, score, _NEG_INF), k)

            if has_aux:
                v, d = jax.vmap(
                    lambda rq, lm, dq, pq, am, asc: one(
                        rq, lm, dq, pq, am, asc
                    )
                )(
                    rowsets_sq, leaf_min_b, ddyn_sq, ph_sq,
                    aux_m_l[s], aux_s_l[s],
                )
            else:
                v, d = jax.vmap(lambda rq, lm, dq: one(rq, lm, dq))(
                    rowsets_sq, leaf_min_b, ddyn_sq
                )
            vals_l.append(v)  # [Q, k]
            docs_l.append(d + base_l[s])
        vals = jnp.concatenate(vals_l, axis=1)  # [Q, per_shard*k]
        docs = jnp.concatenate(docs_l, axis=1)
        # exact ICI merge: gather all shards' candidates, re-rank by
        # (-score, doc) identically on every shard
        vals_all = jnp.moveaxis(lax.all_gather(vals, AXIS), 0, 1).reshape(
            vals.shape[0], -1
        )
        docs_all = jnp.moveaxis(lax.all_gather(docs, AXIS), 0, 1).reshape(
            docs.shape[0], -1
        )

        def merge_one(v, d):
            order = jnp.lexsort((d, -v))[:k]
            return v[order], d[order]

        return jax.vmap(merge_one)(vals_all, docs_all)

    sh = P(AXIS)
    rep = P()
    in_specs = (
        tuple(tuple(sh for _ in pool) for pool in pools_st),
        tuple(tuple(sh for _ in rs) for rs in rowsets_st),
        sh,
        sh,
        sh,
        sh,
        # dense_shared: (pool [S,...], norms [S,nd], avgdl scalar)
        tuple((sh, sh, rep) for _ in dense_shared),
        # dense_dyn: (starts [Q], ws [S,Q][, ub [S,Q,nr], other [S,Q]])
        tuple(
            (rep,) + tuple(sh for _ in dd[1:]) for dd in dense_dyn
        ),
        # phrase_args: (keys per part [S,Q,NK], w [S,Q], norms [S,nd], avgdl)
        tuple(
            (tuple(sh for _ in pa[0]), sh, sh, rep) for pa in phrase_args
        ),
    )
    kw = dict(mesh=mesh, in_specs=in_specs, out_specs=(P(), P()))
    for flag in ("check_vma", "check_rep"):
        try:
            fn = shard_map(local, **kw, **{flag: False})
            break
        except TypeError:
            continue
    else:
        fn = shard_map(local, **kw)
    return fn(
        pools_st, rowsets_st, aux_match, aux_score, alive_st, doc_base,
        dense_shared, dense_dyn, phrase_args,
    )


class PreparedShardedBatch:
    """Device-resident stacked multi-query sharded batch."""

    def __init__(self, searcher: "ShardedSearcher", calls, kmax=None) -> None:
        self.searcher = searcher
        self._calls = calls  # [(query_indices, args, statics, lanes)]
        self.num_queries = sum(len(qis) for qis, *_ in calls)
        self._kmax = kmax  # None = exhaustive for any k

    def run(self, k: int):
        """Per-query (scores f32[k], global docs i32[k]) jax arrays."""
        if self._kmax is not None and k > self._kmax:
            raise ValueError(
                f"prepared for top-k <= {self._kmax} (scored-only multiterm"
                f" plans); re-prepare with k_max >= {k}"
            )
        out = [None] * self.num_queries
        for qis, args, statics, lanes in self._calls:
            kk = min(k, self.searcher.nd_pad, lanes)
            vals, docs = _sharded_topk_batch(*args, k=kk, **statics)
            for j, qi in enumerate(qis):
                out[qi] = (vals[j], docs[j])
        return out

    def top_k(self, k: int) -> List[List[Tuple[int, float]]]:
        res = self.run(k)
        out = []
        for vals, docs in res:
            hits = []
            for v, d in zip(np.asarray(vals), np.asarray(docs)):
                if math.isinf(v) and v < 0:
                    continue
                hits.append((int(d), float(v)))
            out.append(hits[:k])
        return out


class PreparedShardedQuery:
    """Device-resident sharded query: run(k) is dispatch-only.

    Thin Q=1 view over PreparedShardedBatch — single prepared queries use
    the identical execution tiers as the batched path."""

    def __init__(self, batch: "PreparedShardedBatch") -> None:
        self._batch = batch
        self.searcher = batch.searcher

    def run(self, k: int):
        """(scores f32[k], global docs i32[k]) jax arrays, replicated."""
        return self._batch.run(k)[0]

    def top_k(self, k: int) -> List[Tuple[int, float]]:
        return self._batch.top_k(k)[0]
