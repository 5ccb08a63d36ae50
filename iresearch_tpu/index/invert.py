"""Inversion: token tuples -> sorted postings entries.

Reference hot path: core/index/field_data.cpp:985 (``field_data::invert``)
builds an in-RAM hash->byte-pool index one token at a time. The device
replacement is a *segment sort*: the token stream for a field is three flat
arrays ``(tid, doc, pos)``; inversion is one stable sort by ``tid`` (tokens
already arrive in (doc, pos) order) followed by run-length detection of
``(tid, doc)`` runs. Both a numpy host path and a jit-able device path are
provided; they produce identical entry arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class InvertedEntries:
    """Sorted postings entries for one field (input to the encoder)."""

    e_doc: np.ndarray  # u32 [E]
    e_freq: np.ndarray  # u32 [E]
    term_ptr: np.ndarray  # i64 [T+1]
    pos_flat: np.ndarray  # u32 [num_tokens] positions in entry order
    norms: np.ndarray  # u32 [num_docs] tokens per doc
    order: np.ndarray = None  # i64 [num_tokens] arrival->flat permutation
    # (pos_flat == tok_pos[order]; any position-parallel stream reorders
    # the same way: offsets, payloads)


def invert_numpy(
    tok_tid: np.ndarray,
    tok_doc: np.ndarray,
    tok_pos: np.ndarray,
    num_terms: int,
    num_docs: int,
) -> InvertedEntries:
    """Host inversion. Tokens must be in (doc asc, pos asc) arrival order."""
    tok_tid = np.asarray(tok_tid, dtype=np.int64)
    tok_doc = np.asarray(tok_doc, dtype=np.int64)
    tok_pos = np.asarray(tok_pos, dtype=np.uint32)
    n = len(tok_tid)
    norms = np.bincount(tok_doc, minlength=num_docs).astype(np.uint32)
    if n == 0:
        return InvertedEntries(
            e_doc=np.zeros(0, np.uint32),
            e_freq=np.zeros(0, np.uint32),
            term_ptr=np.zeros(num_terms + 1, np.int64),
            pos_flat=np.zeros(0, np.uint32),
            norms=norms,
            order=np.zeros(0, np.int64),
        )
    order = np.argsort(tok_tid, kind="stable")
    stid = tok_tid[order]
    sdoc = tok_doc[order]
    pos_flat = tok_pos[order]

    key = stid * np.int64(num_docs) + sdoc
    is_new = np.empty(n, dtype=bool)
    is_new[0] = True
    np.not_equal(key[1:], key[:-1], out=is_new[1:])
    entry_starts = np.flatnonzero(is_new)
    e_doc = sdoc[entry_starts].astype(np.uint32)
    counts = np.diff(np.append(entry_starts, n))
    e_freq = counts.astype(np.uint32)

    term_ptr = np.zeros(num_terms + 1, dtype=np.int64)
    entry_tid = stid[entry_starts]
    # bincount, not ufunc.at: add.at is ~us/element and dominates at
    # hundreds of millions of tokens
    term_ptr[1:] = np.bincount(entry_tid, minlength=num_terms)
    np.cumsum(term_ptr, out=term_ptr)
    return InvertedEntries(e_doc, e_freq, term_ptr, pos_flat, norms, order)


def invert_device(
    tok_tid: np.ndarray,
    tok_doc: np.ndarray,
    tok_pos: np.ndarray,
    num_terms: int,
    num_docs: int,
) -> InvertedEntries:
    """Device inversion: one device sort + vectorized run detection.

    The jitted kernel works on power-of-two padded token counts (padding
    tokens carry the sentinel tid ``num_terms`` which sorts last and is
    dropped on the host) and returns fixed-shape arrays plus a valid-entry
    count, so recompiles are bounded by the bucket count.
    """
    import jax.numpy as jnp

    n = len(tok_tid)
    norms = np.bincount(
        np.asarray(tok_doc, np.int64), minlength=num_docs
    ).astype(np.uint32)
    if n == 0:
        return InvertedEntries(
            e_doc=np.zeros(0, np.uint32),
            e_freq=np.zeros(0, np.uint32),
            term_ptr=np.zeros(num_terms + 1, np.int64),
            pos_flat=np.zeros(0, np.uint32),
            norms=norms,
            order=np.zeros(0, np.int64),
        )
    cap = 1 << max(1, int(np.ceil(np.log2(n))))
    pad = cap - n
    tid_p = np.concatenate(
        [np.asarray(tok_tid, np.int32), np.full(pad, num_terms, np.int32)]
    )
    doc_p = np.concatenate([np.asarray(tok_doc, np.int32), np.zeros(pad, np.int32)])
    pos_p = np.concatenate([np.asarray(tok_pos, np.uint32), np.zeros(pad, np.uint32)])

    sdoc, spos, stid, e_doc, e_freq, eidx, tid_first, korder = _get_invert_kernel()(
        jnp.asarray(tid_p), jnp.asarray(doc_p), jnp.asarray(pos_p)
    )
    e_doc = np.asarray(e_doc)
    e_freq = np.asarray(e_freq)
    eidx = np.asarray(eidx)
    tid_first = np.asarray(tid_first)
    pos_flat = np.asarray(spos)[:n]

    num_entries = int(eidx[n - 1]) + 1
    e_doc = e_doc[:num_entries].astype(np.uint32)
    e_freq = e_freq[:num_entries].astype(np.uint32)
    entry_tid = tid_first[:num_entries].astype(np.int64)
    term_ptr = np.zeros(num_terms + 1, dtype=np.int64)
    np.add.at(term_ptr, entry_tid + 1, 1)
    np.cumsum(term_ptr, out=term_ptr)
    return InvertedEntries(
        e_doc,
        e_freq,
        term_ptr,
        pos_flat,
        norms,
        np.asarray(korder)[:n].astype(np.int64),
    )


def _make_invert_kernel():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def kernel(tid, doc, pos):
        n = tid.shape[0]
        # stable sort by tid keeps (doc, pos) arrival order inside each term
        order = jnp.argsort(tid, stable=True)
        stid = tid[order]
        sdoc = doc[order]
        spos = pos[order]
        # run boundary where (tid, doc) changes; no 64-bit key needed
        new_tid = jnp.concatenate([jnp.ones(1, bool), stid[1:] != stid[:-1]])
        new_doc = jnp.concatenate([jnp.ones(1, bool), sdoc[1:] != sdoc[:-1]])
        is_new = new_tid | new_doc
        eidx = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        e_freq = jnp.zeros(n, jnp.int32).at[eidx].add(1)
        e_doc = jnp.zeros(n, jnp.int32).at[eidx].max(sdoc)
        tid_first = jnp.zeros(n, jnp.int32).at[eidx].max(stid)
        return sdoc, spos, stid, e_doc, e_freq, eidx, tid_first, order

    return kernel


_KERNEL_CACHE: list = []


def _get_invert_kernel():
    """Lazy jit construction so numpy-only callers never import jax."""
    if not _KERNEL_CACHE:
        _KERNEL_CACHE.append(_make_invert_kernel())
    return _KERNEL_CACHE[0]
