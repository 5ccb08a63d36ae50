"""Dense (doc-grid) representation for high-df terms.

A term whose df approaches the corpus size makes candidate-space
execution O(corpus) *with sort constants*: the 3-operand lax.sort over
an OrHighHigh's ~16M decoded lanes is costly, and the dense tier's
scatter-adds are no better. Such a term is better stored **in doc-grid order**: one
packed freq lane per doc (freq 0 = absent), rows of 128 docs in the
same planar pow2-width classes as the delta pools. Placement in the
[nd] fold then costs *nothing* — the data is already grid-aligned, so
a leaf's contribution is a sequential unpack + elementwise score at
device-memory stream speed, with no sort, no scatter and no gather.

This mirrors what roaring bitmaps / Lucene dense blocks do for high-df
postings (reference: sparse_bitmap.hpp ALL/dense containers), taken one
step further: frequencies, not just membership, live on the grid.

The cache is reader-side acceleration: on-disk postings stay in delta
blocks; the grid pools are derived per segment at open (vectorized
numpy) and uploaded once. The host oracle never reads them, so the
device==oracle exactness gate also validates this path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from iresearch_tpu.formats.bitpack import BITS, bits_class, pack_blocks
from iresearch_tpu.formats.postings import FieldPostings
from iresearch_tpu.formats.spec import BLOCK, NUM_CLASSES, TermCols, pad_docs

# df >= nd / DENSE_MIN_RATIO qualifies a term for the grid representation.
# Set from primitive costs measured on an earlier accelerator, where grid
# streaming cost several times less per lane than the gather/scatter/sort
# alternatives (scripts/bench_placement.py measures them; the GPU figures
# are not taken yet) — so any term whose lists disjunctions/conjunctions
# routinely touch should live on the grid. 64 reaches the luceneutil "Med" band;
# storage is device-side only and capped below.
DENSE_MIN_RATIO = 128
# grid rows cost nd/128 rows per term; cap the cache size per field
DENSE_MAX_TERMS = 512


@dataclass
class DenseCache:
    """Grid-order freq pools for one field's high-df terms (host numpy)."""

    ndrows: int  # rows per term == nd_pad / 128
    # tid -> (width class, first row in that class's pool)
    spans: Dict[int, Tuple[int, int]]
    pools: List[np.ndarray]  # u32 [rows_c, words_per_block(BITS[c])]
    bmaxf: List[np.ndarray]  # u32 [rows_c] max freq per 128-doc row
    # per-row skyline summaries (exec/skyline.py): scorer-independent
    # (f, dl) pairs bounding each row's best score for any scorer that is
    # monotone increasing in freq and decreasing in doc length.
    #   upper bound:  score(bmaxf[r], dl_min[r])  — not necessarily achieved
    #   lower bounds: (f_c, dl_c)   the best lane under default BM25, and
    #                 (f_mdl, dl_min) the min-dl hit lane — both are REAL
    #                 lanes, so their scores are achieved by actual docs
    # dl values are clipped to u16; clipping dl_min DOWN keeps the upper
    # bound valid (looser), and lb pairs are zeroed if their dl overflows
    # (a zero lb is always valid). f_c/f_mdl clip down — monotone-safe.
    dl_min: Optional[List[np.ndarray]] = None  # u16 [rows_c]
    f_c: Optional[List[np.ndarray]] = None  # u16 [rows_c]
    dl_c: Optional[List[np.ndarray]] = None  # u16 [rows_c]
    f_mdl: Optional[List[np.ndarray]] = None  # u16 [rows_c]
    # the avgdl the champion lanes were selected under: when a query
    # scores with default BM25 at exactly this avgdl, (f_c, dl_c) is the
    # row's true argmax and score(f_c, dl_c) an EXACT row-max bound
    avgdl: float = 1.0
    host_bytes: int = 0


def build_dense_cache(
    fp: FieldPostings, num_docs: int, alive: Optional[np.ndarray] = None
) -> Optional[DenseCache]:
    """Select high-df terms and repack their freqs in doc-grid order.

    Returns None when the field has no qualifying terms or the doc axis
    is too small to align to 128-lane rows (pad_docs(nd) % 128 != 0).

    ``alive`` (bool [num_docs], from the snapshot's doc mask) zeroes
    deleted docs' freqs at build: grid lanes of dead docs carry freq 0,
    so every grid consumer — fused scan, skyline survivor rows, gridmix
    probes, WAND row bounds — excludes deletions for free (the
    reference's WAND composes with doc masks the same way,
    /root/reference/core/formats/formats_10.cpp:2426+ over masked
    iterators). The cache is per SegmentReader snapshot, whose mask is
    immutable, so baking it in is sound.
    """
    nd_pad = pad_docs(num_docs)
    if nd_pad % BLOCK != 0:
        return None
    T = fp.num_terms
    if T == 0:
        return None
    df = fp.entries[:, TermCols.DF].astype(np.int64)
    # floor of 32: a shorter list gains nothing from a grid of nd lanes
    thresh = max(32, num_docs // DENSE_MIN_RATIO)
    sel = np.flatnonzero(df >= thresh)
    if len(sel) == 0:
        return None
    if len(sel) > DENSE_MAX_TERMS:
        # no silent caps: terms past the budget fall back to the sparse
        # tiers — record how much grid coverage was dropped
        from iresearch_tpu.utils import log
        from iresearch_tpu.utils.metrics import registry

        dropped = len(sel) - DENSE_MAX_TERMS
        registry().counter(
            "irs_dense_terms_dropped",
            dropped,
            help_="dense-grid-eligible terms past DENSE_MAX_TERMS "
            "(served from sparse tiers instead)",
        )
        log.info(
            "dense cache cap: %d of %d eligible terms kept "
            "(IRS DENSE_MAX_TERMS=%d)", DENSE_MAX_TERMS, len(sel),
            DENSE_MAX_TERMS,
        )
        sel = sel[np.argsort(-df[sel], kind="stable")[:DENSE_MAX_TERMS]]
        sel.sort()
    ndrows = nd_pad // BLOCK

    from iresearch_tpu.formats.postings import decode_term

    per_class: List[List[int]] = [[] for _ in range(NUM_CLASSES)]
    for tid in sel.tolist():
        c = int(bits_class(np.uint32(fp.entries[tid, TermCols.MAX_FREQ])))
        per_class[c].append(tid)

    from iresearch_tpu.formats.bitpack import words_per_block

    spans: Dict[int, Tuple[int, int]] = {}
    pools: List[np.ndarray] = []
    bmaxf: List[np.ndarray] = []
    dl_min_l: List[np.ndarray] = []
    f_c_l: List[np.ndarray] = []
    dl_c_l: List[np.ndarray] = []
    f_mdl_l: List[np.ndarray] = []
    host_bytes = 0
    # native one-pass builder (iresearch_native.cpp:irs_dense_build):
    # streams each term's df entries once instead of ~10 full-grid numpy
    # sweeps — segment-open cold start drops ~25x at 5M docs. Output is
    # element-identical (tests/test_dense_native.py); IRS_DENSE_NATIVE=0
    # forces the numpy path.
    use_native = (
        __import__("os").environ.get("IRS_DENSE_NATIVE", "1") != "0"
    )
    alive_u8 = (
        None
        if alive is None
        else np.ascontiguousarray(alive, np.uint8)
    )
    grid = np.zeros((ndrows, BLOCK), np.uint32)  # reused per term
    # doc-length grid for the skyline summaries (pad lanes dl=1, freq 0)
    dl_grid = np.ones(ndrows * BLOCK, np.float32)
    dl_grid[: len(fp.norms)] = np.maximum(fp.norms, 1).astype(np.float32)
    dl_grid = dl_grid.reshape(ndrows, BLOCK)
    # champion lane selection uses default-BM25 constants; the pair it
    # picks is a REAL lane, hence a valid lower bound for ANY monotone
    # scorer (TFIDF's own best lane may differ — the min-dl pair covers
    # the low-dl end of the frontier)
    avgdl = (
        float(fp.total_term_freq) / float(fp.docs_with_field)
        if fp.docs_with_field
        else 1.0
    )
    _c0, _c1 = 1.2 - 0.9, 0.9 / max(avgdl, 1e-9)
    row_ix = np.arange(ndrows)
    for c in range(NUM_CLASSES):
        tids = per_class[c]
        if tids and use_native:
            from iresearch_tpu import native as _native

            out = _native.dense_build(
                fp.entries, fp.doc_words, fp.base, fp.freq_words,
                np.asarray(tids, np.int32), ndrows, c,
                dl_grid.reshape(-1), alive_u8, _c0, _c1,
            )
            if out is not None:
                packed, bm, dl_min, f_c_a, dl_c_a, f_mdl_a = out
                for i, tid in enumerate(tids):
                    spans[tid] = (c, 1 + i * ndrows)
                pools.append(packed)
                bmaxf.append(bm)
                dl_min_l.append(dl_min)
                f_c_l.append(f_c_a)
                dl_c_l.append(dl_c_a)
                f_mdl_l.append(f_mdl_a)
                host_bytes += (
                    packed.nbytes + bm.nbytes + dl_min.nbytes
                    + f_c_a.nbytes + dl_c_a.nbytes + f_mdl_a.nbytes
                )
                continue
        rows_c = 1 + ndrows * len(tids)  # row 0: zero sentinel
        # pack per term into the preallocated word pool: one [ndrows, 128]
        # unpacked temp at a time (a single class matrix for hundreds of
        # 5M-doc terms would be a multi-GB host allocation)
        packed = np.zeros((rows_c, words_per_block(BITS[c])), np.uint32)
        bm = np.zeros(rows_c, np.uint32)
        dl_min = np.zeros(rows_c, np.uint16)
        f_c_a = np.zeros(rows_c, np.uint16)
        dl_c_a = np.ones(rows_c, np.uint16)
        f_mdl_a = np.zeros(rows_c, np.uint16)
        for i, tid in enumerate(tids):
            start = 1 + i * ndrows
            grid[:] = 0
            docs, freqs = decode_term(fp, tid)
            if alive is not None:
                keep = alive[docs.astype(np.int64)]
                docs, freqs = docs[keep], freqs[keep]
            grid.reshape(-1)[docs.astype(np.int64)] = freqs
            packed[start : start + ndrows] = pack_blocks(grid, BITS[c])
            bm[start : start + ndrows] = grid.max(axis=1)
            spans[tid] = (c, start)
            # skyline row summaries (see DenseCache docstring)
            hit = grid > 0
            dl_hit = np.where(hit, dl_grid, np.float32(np.inf))
            jmin = np.argmin(dl_hit, axis=1)
            dmin = dl_hit[row_ix, jmin]
            dmin_u = np.minimum(
                np.where(np.isfinite(dmin), dmin, 1.0), 65535.0
            )
            dl_min[start : start + ndrows] = dmin_u.astype(np.uint16)
            # the (f_mdl, dl_min) LB pair must quote the REAL dl; if that
            # overflows u16, zero the pair (clipping dl down would claim
            # an unachievable score)
            f_mdl_a[start : start + ndrows] = np.where(
                np.isfinite(dmin) & (dmin <= 65535.0),
                np.minimum(grid[row_ix, jmin], 65535),
                0,
            ).astype(np.uint16)
            gf = grid.astype(np.float32)
            s = np.where(hit, gf / (gf + _c0 + _c1 * dl_grid), -1.0)
            jc = np.argmax(s, axis=1)
            fc = np.minimum(grid[row_ix, jc], 65535)
            dc = dl_grid[row_ix, jc]
            bad = dc > 65535.0  # overflowing dl: zero the pair (valid lb)
            f_c_a[start : start + ndrows] = np.where(bad, 0, fc).astype(
                np.uint16
            )
            dl_c_a[start : start + ndrows] = np.where(
                bad, 1.0, dc
            ).astype(np.uint16)
        pools.append(packed)
        bmaxf.append(bm)
        dl_min_l.append(dl_min)
        f_c_l.append(f_c_a)
        dl_c_l.append(dl_c_a)
        f_mdl_l.append(f_mdl_a)
        host_bytes += (
            packed.nbytes + bm.nbytes + dl_min.nbytes + f_c_a.nbytes
            + dl_c_a.nbytes + f_mdl_a.nbytes
        )
    return DenseCache(
        ndrows=ndrows, spans=spans, pools=pools, bmaxf=bmaxf,
        dl_min=dl_min_l, f_c=f_c_l, dl_c=dl_c_l, f_mdl=f_mdl_l,
        avgdl=float(avgdl), host_bytes=host_bytes,
    )
