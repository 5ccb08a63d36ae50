"""Postings block decode (gather + unpack + delta prefix-sum) vs numpy.

The decode runs as XLA ops inside exec.executor._group_contrib:
``unpack_jnp`` of the gathered rows, then ``cumsum`` onto the block base.
"""

import numpy as np
import pytest

from iresearch_tpu.formats.bitpack import pack_blocks


def _decode_rows(doc_words, freq_words, base, rows_d, rows_f, bd, bf):
    """The executor's decode of gathered rows, as _group_contrib runs it."""
    import jax
    import jax.numpy as jnp

    from iresearch_tpu.formats.bitpack import unpack_jnp

    @jax.jit
    def run(doc_words, freq_words, base, rows_d, rows_f):
        d = unpack_jnp(doc_words[rows_d], bd).astype(jnp.int32)
        docs = base[rows_d][:, None] + jnp.cumsum(d, axis=1)
        f = unpack_jnp(freq_words[rows_f], bf).astype(jnp.float32)
        return docs, f

    return run(doc_words, freq_words, base, rows_d, rows_f)


@pytest.mark.parametrize("bd,bf", [(8, 2), (16, 1), (4, 4), (32, 8), (1, 1)])
def test_kernel_matches_numpy(rng, bd, bf):
    import jax.numpy as jnp

    rows = 32
    deltas = rng.integers(0, 1 << min(bd, 30), size=(rows, 128), dtype=np.uint64).astype(np.uint32)
    freqs = rng.integers(0, 1 << min(bf, 30), size=(rows, 128), dtype=np.uint64).astype(np.uint32)
    base = rng.integers(0, 1000, rows).astype(np.int32)
    dw = pack_blocks(deltas, bd)
    fw = pack_blocks(freqs, bf)
    R = 16
    rd = rng.integers(0, rows, R).astype(np.int32)
    rf = rng.integers(0, rows, R).astype(np.int32)
    docs, f = _decode_rows(
        jnp.asarray(dw), jnp.asarray(fw), jnp.asarray(base),
        jnp.asarray(rd), jnp.asarray(rf), bd, bf,
    )
    want = base[rd][:, None] + np.cumsum(deltas[rd].astype(np.int64), axis=1)
    np.testing.assert_array_equal(np.asarray(docs), want.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(f), freqs[rf].astype(np.float32))
