"""Pow2-bit block packing — the device replacement for simdcomp.

Reference: postings blocks are bit-packed at arbitrary widths 1..32 with
SSE unpack (core/formats/formats_10.cpp:87-130, external/simdcomp). On a vector device
arbitrary widths force cross-word gathers; quantizing widths to powers of
two {1,2,4,8,16,32} makes unpack a *pure vector* op — each 32-bit word
holds 32/b lanes, so decode is repeat(word, 32/b) >> lane_shift & mask:
three VPU ops, no gathers, no cross-word bit surgery. Average storage cost
vs arbitrary widths is <1 bit/lane; decode is memory-bound at full HBM
bandwidth.

A block is 128 lanes (BLOCK) -> 4*b u32 words per block at width b.
"""

from __future__ import annotations

import numpy as np

from iresearch_tpu.formats.spec import BLOCK

BITS = (1, 2, 4, 8, 16, 32)
NUM_BIT_CLASSES = len(BITS)


def bits_class(max_value) -> np.ndarray | int:
    """Smallest class index whose width holds ``max_value``."""
    limits = np.array([1 << b for b in BITS[:-1]], dtype=np.uint64)
    return np.digitize(np.asarray(max_value, np.uint64), limits)


def words_per_block(b: int) -> int:
    return (BLOCK * b) // 32  # == 4*b


def _lane_shifts(b: int) -> np.ndarray:
    # planar layout: lane j lives in word j % (4*b) at bit (j // (4*b)) * b
    g = 32 // b
    return np.repeat(np.arange(g, dtype=np.uint32) * b, words_per_block(b))


def _mask(b: int) -> int:
    return 0xFFFFFFFF if b == 32 else (1 << b) - 1


def pack_blocks(vals: np.ndarray, b: int) -> np.ndarray:
    """[n, 128] u32 (< 2^b) -> [n, 4*b] u32 words, planar layout: lane j
    lives in word ``j % (4*b)`` at bit ``(j // (4*b)) * b`` — so unpack is
    tile(words) >> shift & mask (lane j reads word j % wpb).

    Pure u32 arithmetic: every shifted value stays inside 32 bits (val <
    2^b shifted by <= 32-b), and the per-group loop avoids the [n, g, wpb]
    u64 temp that dominated multi-GB encodes."""
    n = vals.shape[0]
    assert vals.shape == (n, BLOCK)
    g = 32 // b
    wpb = words_per_block(b)
    vals = np.asarray(vals, np.uint32)
    words = vals[:, :wpb].copy()
    for j in range(1, g):
        words |= vals[:, j * wpb : (j + 1) * wpb] << np.uint32(j * b)
    return words


def unpack_blocks(words: np.ndarray, b: int) -> np.ndarray:
    """[n, 4*b] u32 words -> [n, 128] u32 (host/oracle path)."""
    g = 32 // b
    rep = np.tile(words, (1, g))
    return (rep >> _lane_shifts(b)[None, :]) & np.uint32(_mask(b))


def unpack_jnp(words, b: int):
    """jnp twin of unpack_blocks: [R, 4*b] u32 -> [R, 128] u32.

    tile + shift + mask — all elementwise VPU work that XLA fuses into
    the consumer (cumsum / score)."""
    import jax.numpy as jnp

    g = 32 // b
    rep = jnp.tile(words, (1, g))
    shifts = jnp.asarray(_lane_shifts(b))
    return (rep >> shifts[None, :]) & jnp.uint32(_mask(b))
