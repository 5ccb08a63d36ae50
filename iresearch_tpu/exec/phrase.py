"""Device phrase execution: positional intersection as sorted-key set ops.

Reference: by_phrase executes as a conjunction wrapped in a position
checker that leapfrogs per-part position iterators doc by doc
(core/search/phrase_iterator.hpp:75-160). The device formulation processes
ALL docs at once: each part's (doc, position - offset) pairs become sorted
int32 keys ``doc * pos_cap + shifted_pos``; the phrase hits are the keys of
part 0 that appear in every other part (vectorized ``searchsorted``
membership); per-doc tf = number of surviving keys, scored like a term
with the summed-idf weight (phrase stats, bm25.cpp:366-384).

Constraints for the device path (else host fallback): single-term parts,
positions present, and doc*pos_cap fitting int31 (nd_pad * pos_cap < 2^31).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Tuple

import jax
import numpy as np

from iresearch_tpu.formats.bitpack import BITS
from iresearch_tpu.formats.spec import TermCols
from iresearch_tpu.search.scorers import Scorer, score_block

_I32_MAX = np.int32(2**31 - 1)


@dataclass
class PhrasePartSpec:
    """Device inputs for one single-term phrase part."""

    dcls: int
    fcls: int
    pcls: int
    rows_d: np.ndarray  # i32 [NB_pad]
    rows_f: np.ndarray  # i32 [NB_pad]
    rows_p: np.ndarray  # i32 [NPB_pad] rows into the class-pcls pos pool
    ttf: int
    offset: int
    # the part's own field (BySamePosition joins across fields,
    # same_position_filter.hpp — pools come from here)
    field_name: str = ""


@dataclass
class DevicePhraseSpec:
    field_name: str
    parts: List[PhrasePartSpec]
    weight: float  # term_weight(boost, summed idf)
    avgdl: float


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def compile_phrase(
    flt, sr, seg_idx: int, boost: float, prepared, scorer: Scorer
) -> Optional[DevicePhraseSpec]:
    """Build a device spec for a ByPhrase of plain terms or a
    BySamePosition (offset-0 join across fields,
    same_position_filter.hpp), or None for host fallback."""
    from iresearch_tpu.search import filters as F

    if isinstance(flt, F.BySamePosition):
        if not flt.terms:
            return None
        raw_parts = [(0, fld, F.PhraseTerm(t)) for fld, t in flt.terms]
    elif isinstance(flt, F.ByPhrase) and flt.parts:
        raw_parts = [(off, flt.field, p) for off, p in flt.parts]
    else:
        return None
    score_field = raw_parts[0][1]
    fp0 = sr.field(score_field)
    if fp0 is None:
        return None
    nd_pad = _pow2(max(1, sr.num_docs))
    pos_cap = 1
    for _off, fld, _p in raw_parts:
        fpx = sr.field(fld)
        if fpx is None or not fpx.has_positions:
            return None
        pos_cap = max(pos_cap, _pow2(int(fpx.norms.max(initial=1)) + 1))
    if nd_pad * pos_cap >= 2**31:
        return None
    dwf, ttf_field = prepared._field(score_field)
    avgdl = (ttf_field / dwf) if dwf else 1.0
    parts: List[PhrasePartSpec] = []
    idf_sum = 0.0
    for off, fld, p in raw_parts:
        if not isinstance(p, F.PhraseTerm):
            return None
        fp = sr.field(fld)
        tid = sr.lookup_term(fld, p.term)
        if tid is None:
            return None  # a missing part -> empty result; host handles it
        e = fp.entries[tid]
        nb = int(e[TermCols.NBLOCKS])
        nbp = _pow2(max(8, nb))
        rows_d = np.zeros(nbp, np.int32)
        rows_d[:nb] = np.arange(
            int(e[TermCols.DSTART]), int(e[TermCols.DSTART]) + nb, dtype=np.int32
        )
        rows_f = np.zeros(nbp, np.int32)
        rows_f[:nb] = np.arange(
            int(e[TermCols.FSTART]), int(e[TermCols.FSTART]) + nb, dtype=np.int32
        )
        ttf = int(e[TermCols.TTF])
        npb = (ttf + 127) >> 7
        npbp = _pow2(max(1, npb))
        rows_p = np.zeros(npbp, np.int32)  # pad -> sentinel row 0
        rows_p[:npb] = np.arange(
            int(e[TermCols.PSTART]), int(e[TermCols.PSTART]) + npb, dtype=np.int32
        )
        parts.append(
            PhrasePartSpec(
                dcls=int(e[TermCols.DCLS]),
                fcls=int(e[TermCols.FCLS]),
                pcls=int(e[TermCols.PCLS]),
                rows_d=rows_d,
                rows_f=rows_f,
                rows_p=rows_p,
                ttf=ttf,
                offset=int(off),
                field_name=fld,
            )
        )
        # index-wide df of the part's term (host prepare semantics)
        df = 0
        for sr2 in prepared.segments:
            fp2 = sr2.field(fld)
            tid2 = sr2.lookup_term(fld, p.term)
            if fp2 is not None and tid2 is not None:
                df += int(fp2.entries[tid2, TermCols.DF])
        idf_sum += scorer.idf(max(df, 1), max(dwf, 1))
    w = float(scorer.term_weight(boost * flt.boost, idf_sum))
    return DevicePhraseSpec(score_field, parts, w, avgdl)


@dataclass
class PhraseKeysSpec:
    """Positional keys for one segment's phrase/same-position aux leaf.

    Used by the SHARDED executor (parallel/sharded.py): the host decodes
    each part's (doc, position - offset) pairs into sorted int64 keys
    ``doc * 2^32 + shifted_pos`` at prepare time (exactly the oracle's
    formulation, host_eval._eval_positional); the device intersects the
    parts, counts per-doc tf and scores — under shard_map, so the
    per-run phrase work is on-device (reference: phrase_iterator.hpp
    leapfrogs per doc; here whole-shard sorted-set intersection).
    Keys re-encode to i32 with a mesh-uniform pos_cap before upload.
    """

    field_name: str  # scoring field (dl/norms source)
    part_keys64: List[np.ndarray]  # per part: sorted int64 doc*2^32+pos
    weight: float
    avgdl: float
    max_pos: int  # max shifted position over all parts (caplog source)


def compile_phrase_keys(
    flt, sr, seg_idx: int, boost: float, prepared, scorer: Scorer
) -> Optional[PhraseKeysSpec]:
    """Build the per-segment keys spec for ByPhrase/BySamePosition, or
    None when the involved fields lack positions. Empty parts produce
    empty key arrays (=> no matches in this segment), keeping the spec
    structure shard-invariant."""
    from iresearch_tpu.formats.postings import decode_term, term_positions
    from iresearch_tpu.search import filters as F
    from iresearch_tpu.search.expand import expand_phrase_part

    if isinstance(flt, F.BySamePosition):
        parts = []
        for fld, t in flt.terms:
            tid = sr.lookup_term(fld, t)
            parts.append((0, fld, [] if tid is None else [tid]))
    elif isinstance(flt, F.ByPhrase):
        parts = [
            (off, flt.field, expand_phrase_part(p, flt.field, sr))
            for off, p in flt.parts
        ]
    else:
        return None
    if not parts:
        return None
    for _off, fld, _tids in parts:
        fp = sr.field(fld)
        if fp is not None and not fp.has_positions:
            return None
    score_field = parts[0][1]
    dwf, ttf_field = prepared._field(score_field)
    avgdl = (ttf_field / dwf) if dwf else 1.0
    cap = np.int64(1) << 32
    key_arrays: List[np.ndarray] = []
    max_pos = 0
    any_empty = any(not tids for _o, _f, tids in parts)
    idf_sum = 0.0
    for off, fld, tids in parts:
        fp = sr.field(fld)
        arrs = []
        if fp is not None and not any_empty:
            for tid in tids:
                docs, freqs = decode_term(fp, tid)
                flat = term_positions(fp, tid).astype(np.int64)
                doc_of_pos = np.repeat(docs.astype(np.int64), freqs)
                shifted = flat - off
                ok = shifted >= 0
                arrs.append(doc_of_pos[ok] * cap + shifted[ok])
        keys = (
            np.unique(np.concatenate(arrs))
            if arrs
            else np.zeros(0, np.int64)
        )
        if len(keys):
            # max over ALL keys' position field — the largest KEY belongs
            # to the largest doc, whose position need not be the largest
            max_pos = max(max_pos, int((keys & (cap - 1)).max()))
        key_arrays.append(keys)
        # stats exactly as the oracle: per-part df = index-wide df of the
        # terms this SEGMENT expanded (host_eval._phrase_part_df), so w
        # is segment-dependent and must stack per shard
        dwf_f, _ = prepared._field(fld)
        df = prepared._phrase_part_df(fld, tids, sr)
        idf_sum += scorer.idf(max(df, 1), max(dwf_f, 1))
    w = float(scorer.term_weight(boost * flt.boost, idf_sum))
    return PhraseKeysSpec(score_field, key_arrays, w, avgdl, max_pos)


def _part_keys(pool, spec_arrays, bd, bf, bp, ttf, off, pos_cap_log2):
    """Sorted int32 keys doc*pos_cap + (pos - off) of one part; invalid
    slots get I32_MAX (sorts last, never matches). Positions decode from
    the term's packed block rows (format v4) — pure unpack, no gather
    into a flat pool."""
    import jax.numpy as jnp

    doc_words, freq_words, base, pos_words = pool
    rows_d, rows_f, rows_p = spec_arrays
    from iresearch_tpu.formats.bitpack import unpack_jnp

    d = unpack_jnp(doc_words[rows_d], bd).astype(jnp.int32)
    docs = (base[rows_d][:, None] + jnp.cumsum(d, axis=1)).reshape(-1)
    f = unpack_jnp(freq_words[rows_f], bf).astype(jnp.int32).reshape(-1)
    cumf = jnp.cumsum(f)
    pos = unpack_jnp(pos_words[rows_p], bp).astype(jnp.int32).reshape(-1)
    n = pos.shape[0]
    i = jnp.arange(n, dtype=jnp.int32)
    entry = jnp.searchsorted(cumf, i, side="right")
    doc_of_pos = docs[jnp.minimum(entry, docs.shape[0] - 1)]
    shifted = pos - off
    valid = (i < ttf) & (shifted >= 0)
    key = (doc_of_pos << pos_cap_log2) + shifted
    key = jnp.where(valid & (shifted < (1 << pos_cap_log2)), key, _I32_MAX)
    return jnp.sort(key)


@partial(
    jax.jit,
    static_argnames=("gbits", "scorer", "pos_cap_log2", "nd"),
)
def _run_phrase(
    pools,  # tuple per part: (doc_words, freq_words, base, pos_words)
    specs,  # tuple per part: (rows_d, rows_f, rows_p)
    ttfs,  # i32 [m]
    offs,  # i32 [m]
    weight,  # f32 scalar
    avgdl,  # f32 scalar
    norms,  # f32 [nd]
    *,
    gbits,  # tuple per part: (doc_bits, freq_bits, pos_bits)
    scorer: Scorer,
    pos_cap_log2: int,
    nd: int,
):
    import jax.numpy as jnp

    keys0 = _part_keys(
        pools[0], specs[0], gbits[0][0], gbits[0][1], gbits[0][2],
        ttfs[0], offs[0], pos_cap_log2,
    )
    alive_keys = keys0 != _I32_MAX
    for j in range(1, len(pools)):
        kj = _part_keys(
            pools[j], specs[j], gbits[j][0], gbits[j][1], gbits[j][2],
            ttfs[j], offs[j], pos_cap_log2,
        )
        idx = jnp.searchsorted(kj, keys0)
        found = kj[jnp.minimum(idx, kj.shape[0] - 1)] == keys0
        alive_keys = alive_keys & found
    doc_of_key = keys0 >> pos_cap_log2
    tf = (
        jnp.zeros(nd, jnp.float32)
        .at[jnp.where(alive_keys, doc_of_key, nd - 1)]
        .add(jnp.where(alive_keys, 1.0, 0.0), mode="drop")
    )
    match = tf > 0
    dl = norms
    sc = score_block(
        scorer,
        jnp.float32(weight),
        tf.reshape(1, -1),
        dl.reshape(1, -1),
        avgdl,
        xp=jnp,
    ).reshape(-1)
    return match, jnp.where(match, sc, 0.0)


def run_phrase_dense(
    spec: DevicePhraseSpec, sr, scorer: Scorer, nd_pad: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Execute on device -> (match bool [nd_pad], score f32 [nd_pad])."""
    import jax.numpy as jnp

    dfield = sr.device_field(spec.field_name)
    pos_cap = 1
    for p in spec.parts:
        fpx = sr.field(p.field_name or spec.field_name)
        pos_cap = max(pos_cap, _pow2(int(fpx.norms.max(initial=1)) + 1))
    pos_cap_log2 = int(np.log2(pos_cap))
    pools = []
    specs = []
    gbits = []
    for p in spec.parts:
        dfield_p = sr.device_field(p.field_name or spec.field_name)
        pools.append(
            (
                dfield_p.doc_words[p.dcls],
                dfield_p.freq_words[p.fcls],
                dfield_p.base[p.dcls],
                dfield_p.pos_words(p.pcls),
            )
        )
        specs.append(
            (jnp.asarray(p.rows_d), jnp.asarray(p.rows_f), jnp.asarray(p.rows_p))
        )
        gbits.append((BITS[p.dcls], BITS[p.fcls], BITS[p.pcls]))
    match, score = _run_phrase(
        tuple(pools),
        tuple(specs),
        jnp.asarray([p.ttf for p in spec.parts], jnp.int32),
        jnp.asarray([p.offset for p in spec.parts], jnp.int32),
        jnp.float32(spec.weight),
        jnp.float32(spec.avgdl),
        dfield.norms,
        gbits=tuple(gbits),
        scorer=scorer,
        pos_cap_log2=pos_cap_log2,
        nd=nd_pad,
    )
    return match, score
