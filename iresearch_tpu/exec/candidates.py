"""Scale-proportional executors: query cost O(postings), not O(corpus).

The reference's hot path touches only postings — leapfrog conjunction
(core/search/conjunction.hpp:155-230), heap/block disjunction
(core/search/disjunction.hpp:860-1100), skip lists
(core/formats/formats_10.cpp:320-323). The round-1 dense executor folded
per-leaf [L, nd_pad] arrays instead: exact, but O(corpus) per query — and
its scatter-adds were measured far slower per element than streams or
sorts, which is the real cost at any corpus size.

This module's answer: three scatter-free tiers picked at plan time
(exec/plan.py). Only gathers, sorts, segmented scans and top-k — all
full-speed vector ops:

* ``direct`` — single-span leaf (one term): decoded docs are unique, so
  contributions ARE final scores; top-k straight over the [P] decoded
  lanes.
* ``join`` — conjunction with a single-span driver leaf: candidates are
  the driver's decoded docs (ascending by construction); every other span
  binary-searches each candidate into its own decoded doc array and
  GATHERS its contribution (the dense-dataflow leapfrog AND).
* ``sort`` — general positive trees: decoded (doc, score, leaf|match)
  lanes sort by doc; per-(doc, leaf) sums come from a segmented
  Hillis-Steele scan over the doc-runs (log2(P) masked-add sweeps), and
  each run's last lane is its doc's candidate.

All tiers compose with block-max WAND: rows pruned by θ redirect to the
sentinel row 0 and decode to zero contributions. Safety: a tier other
than dense is only used for *covering* trees — every match carries at
least one postings entry (plan._covering_tree) — so docs absent from the
decoded lanes cannot match.
"""

from __future__ import annotations

from typing import Sequence

from iresearch_tpu.search.scorers import Scorer

_NEG_INF = float("-inf")
_IMAX32 = 2**31 - 1


def topk_docs(masked, doc_arr, k: int):
    """top_k by (-score, doc): deterministic doc-id tie-break.

    ``lax.top_k`` breaks ties by lane position; in the dense executor lane
    == doc so ties resolve by doc id (matching the host oracle's
    (-score, doc) order), but candidate-space lanes are arbitrary. Fix up
    the boundary tie group: its members are the smallest-doc ties, found
    with one extra top_k over negated doc ids — no full sort.
    """
    import jax.numpy as jnp
    from jax import lax

    from iresearch_tpu.ops.topk import wide_top_k

    vals, idx = wide_top_k(masked, k)
    docs0 = doc_arr[idx]
    if k == 1:
        # single winner: smallest doc among max-score ties
        tie_key = jnp.where(masked == vals[0], doc_arr, jnp.int32(_IMAX32))
        return vals, jnp.min(tie_key)[None]
    thetak = vals[k - 1]
    tie_out = vals == thetak  # trailing run of the sorted top-k values
    tie_key = jnp.where(masked == thetak, doc_arr, jnp.int32(_IMAX32))
    # k smallest tie docs, ascending
    small_ties = -wide_top_k(-tie_key, k)[0]
    tie_rank = jnp.cumsum(tie_out.astype(jnp.int32)) - 1
    out_docs = jnp.where(
        tie_out, small_ties[jnp.maximum(tie_rank, 0)], docs0
    )
    return vals, out_docs


def dense_probe(dargs, dstat, cdocs, scorer: Scorer, jnp, dl=None):
    """(score f32 [P], hit bool [P]) of a dense-grid span at candidate docs.

    The grid representation makes probing trivial: doc d lives in row
    ``start + d//128`` lane ``d%128``, and the planar packing puts lane j
    in word ``j % (4b)`` at bit ``(j // (4b)) * b`` — ONE u32 word gather
    per candidate plus a norms gather, vs the sparse probe's whole-row
    decode (~wpb words/candidate)."""
    from iresearch_tpu.formats.bitpack import words_per_block
    from iresearch_tpu.formats.spec import BLOCK
    from iresearch_tpu.search.scorers import score_block

    pool, start, w, norms_g, avgdl_d = dargs[:5]
    bits, _leaf, ndrows = dstat[:3]
    nd = ndrows * BLOCK
    cd = jnp.clip(cdocs, 0, nd - 1)
    row = start + (cd >> 7)
    lane = cd & (BLOCK - 1)
    wpb = words_per_block(bits)
    word_ix = lane % wpb
    shift = ((lane // wpb) * bits).astype(jnp.uint32)
    mask = jnp.uint32(0xFFFFFFFF if bits == 32 else (1 << bits) - 1)
    w32 = pool[row, word_ix]
    freq = ((w32 >> shift) & mask).astype(jnp.float32)
    hit = (freq > 0) & (cdocs < nd) & (cdocs >= 0)
    if dl is None:
        dl = norms_g[cd]
    # else: caller already holds this doc's length (e.g. the join driver's
    # decoded inline norms — dl is a per-doc field property), saving the
    # norms gather
    sc = score_block(scorer, w, freq, dl, avgdl_d, xp=jnp)
    return jnp.where(hit, sc, 0.0), hit


def decode_flat(pools, rowsets, avgdl, gbits, scorer: Scorer, slicer=None):
    """Decode every row group into flat per-lane arrays.

    Returns (docs i32 [P], score f32 [P], matched bool [P], leaf i32 [P])
    with P = sum over groups of rows*128. ``slicer`` optionally narrows
    each rowset (WAND sampled phase).
    """
    import jax.numpy as jnp

    from iresearch_tpu.exec.executor import _group_contrib

    docs_l, sc_l, m_l, leaf_l = [], [], [], []
    for gi, (pool, rs) in enumerate(zip(pools, rowsets)):
        bd, bf, bn = gbits[gi]
        rows_d, rows_f, rows_n, w, leaf = (
            rs[:5] if slicer is None else slicer(rs)
        )
        docs, sc, m = _group_contrib(
            pool, rows_d, rows_f, rows_n, w, bd, bf, bn, avgdl[gi], scorer
        )
        R = docs.shape[0]
        docs_l.append(docs.reshape(-1))
        sc_l.append(sc.reshape(-1))
        m_l.append(m.reshape(-1))
        leaf_l.append(jnp.broadcast_to(leaf[:, None], (R, docs.shape[1])).reshape(-1))
    if len(docs_l) == 1:
        return docs_l[0], sc_l[0], m_l[0], leaf_l[0]
    return (
        jnp.concatenate(docs_l),
        jnp.concatenate(sc_l),
        jnp.concatenate(m_l),
        jnp.concatenate(leaf_l),
    )


def dslice_topk(
    pool, starts, nreal, w, avgdl, alive,
    *, gbits, scorer, k, R: int,
):
    """Single-term top-k via CONTIGUOUS slice decode.

    A term's postings rows are contiguous in each class pool by
    construction (formats/postings.py appends per class in tid order), so
    the decode needs no row gather at all: three dynamic_slices stream the
    rows at device-memory speed, where the row-gather decode reads a
    gathered block per row (the luceneutil MedTerm shape is 713 blocks).
    Rows past the term's real count decode other terms' data and are
    masked by ``nreal``; block-max pruning is NOT applied here — in
    candidate space pruning only redirects rows to the sentinel (same
    lane count), so for a single span it saves nothing and costs a sort.

    Reference: term_query.cpp:35-75 + the postings_reader refill loop
    (formats_10.cpp:2089-2120).
    """
    import jax.numpy as jnp
    from jax import lax

    from iresearch_tpu.exec.executor import _group_contrib
    from iresearch_tpu.formats.bitpack import unpack_jnp, words_per_block
    from iresearch_tpu.search.scorers import score_block

    bd, bf, bn = gbits
    doc_words, freq_words, nrm_words, base, norms = pool
    dwords = lax.dynamic_slice(
        doc_words, (starts[0], 0), (R, words_per_block(bd))
    )
    fwords = lax.dynamic_slice(
        freq_words, (starts[1], 0), (R, words_per_block(bf))
    )
    base_r = lax.dynamic_slice(base, (starts[0],), (R,))
    nwords = (
        lax.dynamic_slice(
            nrm_words, (starts[2], 0), (R, words_per_block(bn))
        )
        if bn >= 0
        else None
    )
    return dslice_core(
        dwords, fwords, nwords, base_r, norms, nreal, w, avgdl, alive,
        gbits=gbits, scorer=scorer, k=k, R=R,
    )


def dslice_core(
    dwords, fwords, nwords, base_r, norms, nreal, w, avgdl, alive,
    *, gbits, scorer, k, R: int,
):
    """Decode + score + top-k over one query's pre-gathered [R, wpb] rows.

    Shared by the single-query path (contiguous dynamic_slices above) and
    the batched path (exec/batch.py gathers all queries' rows in ONE flat
    row-index gather — vmapping the dynamic_slices lowers to per-element
    gathers instead)."""
    import jax.numpy as jnp

    from iresearch_tpu.formats.bitpack import unpack_jnp
    from iresearch_tpu.search.scorers import score_block

    bd, bf, bn = gbits
    d = unpack_jnp(dwords, bd).astype(jnp.int32)
    docs = base_r.astype(jnp.int32)[:, None] + jnp.cumsum(d, axis=1)
    f = unpack_jnp(fwords, bf).astype(jnp.float32)
    if bn >= 0:
        dl = jnp.maximum(unpack_jnp(nwords, bn).astype(jnp.float32), 1.0)
    else:
        dl = norms[jnp.clip(docs, 0, norms.shape[0] - 1)]
    sc = score_block(scorer, w, f, dl, avgdl, xp=jnp)
    rowix = jnp.arange(R, dtype=jnp.int32)
    live = (rowix < nreal)[:, None] & (f > 0)
    if alive is not None:
        live = live & alive[jnp.clip(docs, 0, alive.shape[0] - 1)]
    # out-of-range rows may decode wild doc ids; they are masked, but park
    # their ids so tie-break dedup can't collide with real docs
    docs = jnp.where(live, docs, jnp.int32(_IMAX32))
    return topk_docs(
        jnp.where(live, sc, _NEG_INF).reshape(-1), docs.reshape(-1), k
    )


def direct_topk(pools, rowsets, avgdl, alive, *, gbits, scorer, k):
    """Single-span top-k: decoded docs are unique, so no combine is needed.

    The TermQuery hot path (reference: term_query.cpp:35-75 +
    postings_reader refill) as decode → score → top_k over [P] lanes.
    Trailing padding lanes repeat the last real doc with freq 0 and the
    sentinel decodes to doc 0 with freq 0 — both carry matched=False.
    """
    import jax.numpy as jnp

    docs, sc, m, _ = decode_flat(pools, rowsets, avgdl, gbits, scorer)
    match = m if alive is None else m & alive[docs]
    return topk_docs(jnp.where(match, sc, _NEG_INF), docs, k)


def sorted_topk(
    pools, rowsets, avgdl, leaf_min, alive,
    *, tree, gbits, scorer, num_leaves, k, slicer=None,
    dense_leaf=None,  # (score_d [L,nd], count_d [L,nd], leaves tuple)
):
    """Sort + segmented-scan candidate top-k for covering trees.

    Sorting by doc makes duplicate docs (same doc hit by several terms)
    contiguous; a segmented inclusive scan (Hillis-Steele doubling with a
    run-connection flag — pure shifted masked adds, NO scatter) leaves
    each run's total at its last lane, which becomes the doc's candidate
    slot. The boolean tree folds elementwise over those lanes.
    """
    import jax.numpy as jnp
    from jax import lax

    from iresearch_tpu.exec.executor import _fold_tree

    docs, sc, m, leaf = decode_flat(pools, rowsets, avgdl, gbits, scorer, slicer)
    P = docs.shape[0]
    # pack (leaf, matched) into one payload so the sort carries 3 operands
    pay = leaf * 2 + m.astype(jnp.int32)
    sdocs, ssc, spay = lax.sort((docs, sc, pay), num_keys=1)
    sleaf = spay >> 1
    scnt = (spay & 1).astype(jnp.float32)
    # channels: per-leaf score + per-leaf count (floats; counts are small
    # integers so f32 addition is exact)
    chans = []
    for l in range(num_leaves):
        on = sleaf == l
        chans.append(jnp.where(on, ssc, 0.0))
        chans.append(jnp.where(on, scnt, 0.0))
    # segmented inclusive scan over doc-runs
    conn = jnp.concatenate(
        [jnp.zeros(1, bool), sdocs[1:] == sdocs[:-1]]
    )  # lane connected to previous lane's run
    shift = 1
    while shift < P:
        c_prev = jnp.concatenate([jnp.zeros(shift, bool), conn[:-shift]])
        chans = [
            c + jnp.where(conn, jnp.concatenate([jnp.zeros(shift, c.dtype), c[:-shift]]), 0)
            for c in chans
        ]
        conn = conn & c_prev
        shift <<= 1
    is_end = jnp.concatenate([sdocs[:-1] != sdocs[1:], jnp.ones(1, bool)])
    leaf_score = jnp.stack([jnp.where(is_end, chans[2 * l], 0.0) for l in range(num_leaves)])
    leaf_count = jnp.stack(
        [jnp.where(is_end, chans[2 * l + 1], 0.0).astype(jnp.int32) for l in range(num_leaves)]
    )
    # dense-grid contributions at the candidate docs (gridmix view B):
    # gathered from the pre-accumulated per-leaf grid arrays — two
    # gathers per DENSE LEAF, independent of how many dense spans feed it
    # (a fuzzy expansion can have dozens). Added at run-end lanes only,
    # so each doc counts once.
    if dense_leaf is not None:
        score_d, count_d, dense_leaves = dense_leaf
        ndg = score_d.shape[1]
        cd = jnp.clip(sdocs, 0, ndg - 1)
        on = (sdocs >= 0) & (sdocs < ndg) & is_end
        for l in dense_leaves:
            leaf_score = leaf_score.at[l].add(
                jnp.where(on, score_d[l][cd], 0.0)
            )
            leaf_count = leaf_count.at[l].add(
                jnp.where(on, count_d[l][cd], 0)
            )
    leaf_match = leaf_count >= leaf_min[:, None]
    leaf_score = jnp.where(leaf_match, leaf_score, 0.0)
    match, score = _fold_tree(tree, leaf_match, leaf_score, None, None, P, jnp)
    # only run-ends are candidates; covering trees cannot match elsewhere
    # (their counts were zeroed above)
    match = match & is_end
    if alive is not None:
        match = match & alive[sdocs]
    return topk_docs(jnp.where(match, score, _NEG_INF), sdocs, k)


def join_topk(
    pools, rowsets, avgdl, leaf_min, alive, nreal,
    *, tree, gbits, scorer, num_leaves, k, driver_gi, group_leaf,
    dense_args=(), dense_static=(),
):
    """Block-probe conjunction join: the leapfrog AND at full VPU speed
    (reference: conjunction.hpp:155-230).

    Candidates are the driver span's decoded docs (the smallest required
    leaf, so P_d is small). Every other span is NEVER fully decoded:
    each candidate binary-searches the span's per-block ``base`` doc ids
    (sort-based searchsorted) to find the one 128-doc
    block that could contain it, gathers just that block's packed words,
    and probes all 128 lanes with a compare+masked-sum. Work per span is
    P_d × 128 vector lanes + P_d tiny gathers — independent of the span's
    own length, so AndHighLow costs the Low side, like the reference.
    """
    import jax.numpy as jnp

    from iresearch_tpu.exec.executor import _fold_tree, _group_contrib
    from iresearch_tpu.formats.bitpack import unpack_jnp
    from iresearch_tpu.search.scorers import score_block

    IMAX = jnp.int32(_IMAX32)
    G = len(pools)

    def probe(gi, cdocs):
        """(freq f32 [P], weight f32 [P], dl f32 [P] or None) of span
        ``gi`` at each candidate doc: block-probe without decoding the
        span. dl comes from the span's inline norm block (format v5);
        None for legacy segments (caller gathers norms[cdocs])."""
        bdg, bfg, bng = gbits[gi]
        doc_words, freq_words, nrm_words, base, _norms = pools[gi]
        g_rows_d, g_rows_f, g_rows_n, g_w, _gl = rowsets[gi][:5]
        R = g_rows_d.shape[0]
        # per-row first-doc keys, ascending over the span's real rows;
        # pad rows map to IMAX so they sort last
        base_key = jnp.where(
            jnp.arange(R, dtype=jnp.int32) < (nreal[gi] >> 7),
            base[g_rows_d].astype(jnp.int32),
            IMAX,
        )
        rowpos = jnp.clip(
            jnp.searchsorted(base_key, cdocs, side="right", method="sort")
            .astype(jnp.int32) - 1,
            0,
            R - 1,
        )
        # decode only the probed block per candidate
        deltas = unpack_jnp(doc_words[g_rows_d[rowpos]], bdg).astype(jnp.int32)
        docs_row = base[g_rows_d[rowpos]].astype(jnp.int32)[:, None] + jnp.cumsum(
            deltas, axis=1
        )
        freqs_row = unpack_jnp(freq_words[g_rows_f[rowpos]], bfg)
        eq = docs_row == cdocs[:, None]
        # partial-block repeat lanes carry freq 0, so summing over the
        # (possibly repeated) equal lanes yields the real frequency
        freq_at = jnp.sum(jnp.where(eq, freqs_row, 0), axis=1).astype(jnp.float32)
        dl_at = None
        if bng >= 0:
            nrm_row = unpack_jnp(nrm_words[g_rows_n[rowpos]], bng)
            dl_at = jnp.maximum(
                jnp.sum(jnp.where(eq, nrm_row, 0), axis=1).astype(jnp.float32),
                1.0,
            )
        return freq_at, g_w[rowpos], dl_at

    def decode_span(gi):
        bd, bf, bn = gbits[gi]
        rows_d, rows_f, rows_n, w, _leaf = rowsets[gi][:5]
        docs, sc, m, dl = _group_contrib(
            pools[gi], rows_d, rows_f, rows_n, w, bd, bf, bn, avgdl[gi],
            scorer, want_dl=True,
        )
        P = docs.shape[0] * docs.shape[1]
        lane = jnp.arange(P, dtype=jnp.int32)
        cdocs = jnp.where(lane < nreal[gi], docs.reshape(-1), IMAX)
        # dl may be [R,128] (inline norm pools) or [R,128]-broadcastable
        # via norms[docs] (legacy) — both reshape to per-lane
        return cdocs, sc.reshape(-1), m.reshape(-1), dl.reshape(-1)

    cand_gis = [driver_gi] if driver_gi >= 0 else list(range(G))
    out_docs, out_masked = [], []
    for ci in cand_gis:
        cdocs, csc, cm, cdl = decode_span(ci)
        P = cdocs.shape[0]
        leaf_score = [jnp.zeros(P, jnp.float32) for _ in range(num_leaves)]
        leaf_count = [jnp.zeros(P, jnp.int32) for _ in range(num_leaves)]
        li = group_leaf[ci]
        leaf_score[li] = jnp.where(cm, csc, 0.0)
        leaf_count[li] = cm.astype(jnp.int32)
        valid = cm  # pads and partial-block repeats are never candidates
        for gi in range(G):
            if gi == ci:
                continue
            freq_at, w_at, dl_at = probe(gi, cdocs)
            hit = freq_at > 0
            if dl_at is None:  # legacy span: per-lane norms gather
                norms_g = pools[gi][4]
                dl_at = norms_g[jnp.minimum(cdocs, norms_g.shape[0] - 1)]
            sc_at = score_block(scorer, w_at, freq_at, dl_at, avgdl[gi], xp=jnp)
            lj = group_leaf[gi]
            leaf_score[lj] = leaf_score[lj] + jnp.where(hit, sc_at, 0.0)
            leaf_count[lj] = leaf_count[lj] + hit.astype(jnp.int32)
            if driver_gi < 0 and gi < ci:
                valid = valid & ~hit  # dedup: earlier span owns the doc
        # dense-grid probed spans: one word gather per candidate. The
        # driver's decoded dl is reused ONLY when the span lives in the
        # same field (dl is per-(doc, field) — dstat[3] is the static
        # same-field flag); otherwise dense_probe gathers from the span's
        # own norms. Pad lanes are gated by cm.
        for dargs, dstat in zip(dense_args, dense_static):
            sc_at, hit = dense_probe(
                dargs, dstat, cdocs, scorer, jnp,
                dl=cdl if dstat[3] else None,
            )
            lj = dstat[1]
            leaf_score[lj] = leaf_score[lj] + jnp.where(hit, sc_at, 0.0)
            leaf_count[lj] = leaf_count[lj] + hit.astype(jnp.int32)

        leaf_score_s = jnp.stack(leaf_score)
        leaf_count_s = jnp.stack(leaf_count)
        leaf_match = leaf_count_s >= leaf_min[:, None]
        leaf_score_s = jnp.where(leaf_match, leaf_score_s, 0.0)
        match, score = _fold_tree(
            tree, leaf_match, leaf_score_s, None, None, P, jnp
        )
        match = match & valid
        if alive is not None:
            match = match & alive[jnp.minimum(cdocs, alive.shape[0] - 1)]
        out_docs.append(cdocs)
        out_masked.append(jnp.where(match, score, _NEG_INF))
    if len(out_docs) == 1:
        return topk_docs(out_masked[0], out_docs[0], k)
    return topk_docs(
        jnp.concatenate(out_masked), jnp.concatenate(out_docs), k
    )


def merge_topk_lists(va, da, vb, db, k: int):
    """Exact union of two per-view top-k lists, deduped by doc (max
    score wins — views only ever underestimate), ordered (-score, doc)."""
    import jax.numpy as jnp
    from jax import lax

    vals = jnp.concatenate([va, vb])
    docs = jnp.concatenate([da, db])
    # -inf slots carry arbitrary docs; park them on IMAX so they can't
    # collide with a real doc during dedup
    docs = jnp.where(jnp.isfinite(vals), docs, jnp.int32(_IMAX32))
    sd, nsv = lax.sort((docs, -vals), num_keys=2)  # doc asc, score desc
    sv = -nsv
    first = jnp.concatenate([jnp.ones(1, bool), sd[1:] != sd[:-1]])
    keep = jnp.where(first & (sd != _IMAX32), sv, _NEG_INF)
    return topk_docs(keep, sd, k)


def gridmix_topk(
    pools, rowsets, avgdl, leaf_min, alive,
    *, tree, gbits, scorer, num_leaves, k, nd,
    dense_args, dense_static,
):
    """Dual-view execution for sum-merged trees mixing dense-grid and
    sparse spans — no sort of the dense mass, no scatter of the sparse.

    View A evaluates the tree on the [nd] grid from the dense spans only
    (sparse contributions missing). View B evaluates it exactly at the
    sparse spans' candidate docs (dense spans probed per lane). Every doc
    is exact in >=1 view, and a view can only UNDERestimate (positive
    sum-merged contributions), so the union of the two top-k lists
    contains the true top-k; dedup keeps the max (= exact) score.
    Proof sketch: if doc X is true top-k and not sparse-hit, its grid
    score is exact; any doc preceding X in view A has true score >= its
    grid score >= X's — so k docs preceding X in A means X isn't true
    top-k. Sparse-hit docs are exact in view B by the same argument."""
    import jax.numpy as jnp

    from iresearch_tpu.exec.executor import _dense_contrib, _fold_tree

    # per-leaf dense grid accumulations, shared by both views
    score_d = jnp.zeros((num_leaves, nd), jnp.float32)
    count_d = jnp.zeros((num_leaves, nd), jnp.int32)
    for dargs, dstat in zip(dense_args, dense_static):
        sc, m = _dense_contrib(dargs, dstat, scorer, nd, jnp)
        score_d = score_d.at[dstat[1]].add(sc)
        count_d = count_d.at[dstat[1]].add(m.astype(jnp.int32))
    dense_leaves = tuple(sorted({dstat[1] for dstat in dense_static}))

    leaf_match = count_d >= leaf_min[:, None]
    leaf_score = jnp.where(leaf_match, score_d, 0.0)
    match, score = _fold_tree(tree, leaf_match, leaf_score, None, None, nd, jnp)
    grid_ids = jnp.arange(nd, dtype=jnp.int32)
    if alive is not None:
        match = match & alive
    va, da = topk_docs(jnp.where(match, score, _NEG_INF), grid_ids, k)

    # view B's candidate space is only the sparse lanes — its k caps there
    p_sp = sum(rs[0].shape[0] for rs in rowsets) * 128
    vb, db = sorted_topk(
        pools, rowsets, avgdl, leaf_min, alive,
        tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
        k=min(k, p_sp),
        dense_leaf=(score_d, count_d, dense_leaves),
    )
    return merge_topk_lists(va, da, vb, db, k)


def wand_theta(
    pools, sorted_sets, avgdl, leaf_min, alive,
    *, tree, gbits, scorer, num_leaves, k, sample, mode,
    wand_mode="exact",
):
    """Lower-bound θ from the highest-upper-bound `sample` blocks per group.

    Partial decode can only shrink matches and scores, so the k-th partial
    score is a lower bound of the true k-th — the same argument as the
    dense wand_body phase 1, evaluated in candidate space.
    """
    import jax.numpy as jnp
    from jax import lax

    def slicer(rs):
        return tuple(r[: min(sample, r.shape[0])] for r in rs[:5])

    if mode == "direct":
        docs, sc, m, _ = decode_flat(
            pools, sorted_sets, avgdl, gbits, scorer, slicer
        )
        pm = m if alive is None else m & alive[docs]
        from iresearch_tpu.ops.topk import wide_top_k

        theta = wide_top_k(jnp.where(pm, sc, _NEG_INF), k)[0][k - 1]
    else:  # sort-compact partial fold
        vals, _docs = sorted_topk(
            pools, sorted_sets, avgdl, leaf_min, alive,
            tree=tree, gbits=gbits, scorer=scorer,
            num_leaves=num_leaves, k=k, slicer=slicer,
        )
        theta = vals[k - 1]
    if wand_mode in ("strict", "approx"):
        # reference MinStrict (formats_10.cpp:2434): no float-order guard,
        # ties at θ within reorder ulps may be pruned (approx reaches here
        # only for tiers that keep θ-pruning, e.g. join)
        return theta
    # float-order guard (same epsilon dance as wand_body / the reference's
    # nextafter, formats_10.cpp:2434-2441)
    return jnp.where(
        jnp.isfinite(theta), theta - jnp.abs(theta) * 1e-5 - 1e-30, theta
    )


def candidate_body(
    pools,
    rowsets,
    avgdl,
    leaf_min,
    alive,
    nreal=None,  # traced i32 [G] real-lane counts (join mode)
    *,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    k: int,
    mode: str,  # "direct" | "sort" | "join" | "gridmix"
    driver_gi: int = 0,
    group_leaf: tuple = (),
    wand: bool = False,
    sample: int = 16,
    wand_mode: str = "exact",  # "exact" | "strict" | "approx" — see wand_body
    nd: int = 0,  # gridmix: padded doc-axis length
    dense_args=(),
    dense_static=(),
):
    """Unified scale-proportional executor body (shared single/batch/shard)."""
    import jax.numpy as jnp

    if mode == "gridmix":
        return gridmix_topk(
            pools, rowsets, avgdl, leaf_min, alive,
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            k=k, nd=nd, dense_args=dense_args, dense_static=dense_static,
        )

    sets = rowsets
    if wand:
        sorted_sets = []
        for rs in rowsets:
            rows_d, rows_f, rows_n, w, leaf, ub, other = rs
            order = jnp.argsort(-ub)
            sorted_sets.append(
                (rows_d[order], rows_f[order], rows_n[order], w[order],
                 leaf[order], ub[order], other[order])
            )
        if wand_mode == "approx" and mode in ("direct", "sort"):
            # approximate mode: decode only the `sample` highest-bound
            # blocks per group — one pass, no θ phase (candidate-space
            # analog of wand_body's sampled-pass-only return). Join mode
            # keeps θ-pruning (its nreal lane accounting assumes full
            # driver rowsets); approx there = strict θ.
            sets = [
                tuple(r[: min(sample, r.shape[0])] for r in rs)
                for rs in sorted_sets
            ]
        else:
            theta = wand_theta(
                pools, sorted_sets, avgdl, leaf_min, alive,
                tree=tree, gbits=gbits, scorer=scorer,
                num_leaves=num_leaves,
                k=k, sample=sample, mode=mode, wand_mode=wand_mode,
            )

            def prune(rs):
                rows_d, rows_f, rows_n, w, leaf, ub, other = rs
                keep = (ub + other) >= theta
                return (
                    jnp.where(keep, rows_d, 0),
                    jnp.where(keep, rows_f, 0),
                    jnp.where(keep, rows_n, 0),
                    jnp.where(keep, w, 0.0),
                    leaf, ub, other,
                )

            sets = [prune(rs) for rs in sorted_sets]

    if mode == "direct":
        return direct_topk(
            pools, sets, avgdl, alive, gbits=gbits, scorer=scorer, k=k
        )
    if mode == "join":
        return join_topk(
            pools, sets, avgdl, leaf_min, alive, nreal,
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            k=k, driver_gi=driver_gi, group_leaf=group_leaf,
            dense_args=dense_args, dense_static=dense_static,
        )
    return sorted_topk(
        pools, sets, avgdl, leaf_min, alive,
        tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves, k=k,
    )
