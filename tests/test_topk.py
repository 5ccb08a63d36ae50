"""wide_top_k must be bit-identical to lax.top_k, including tie order.

The tournament is called directly on these small rows, which
``wide_top_k`` itself hands to ``lax.top_k``."""

import jax.numpy as jnp
import numpy as np
from jax import lax

from iresearch_tpu.ops.topk import _tournament, wide_top_k


def _check(x, k, chunk):
    ref_v, ref_i = lax.top_k(x, k)
    got_v, got_i = _tournament(x, k, chunk)
    np.testing.assert_array_equal(np.asarray(ref_v), np.asarray(got_v))
    np.testing.assert_array_equal(np.asarray(ref_i), np.asarray(got_i))


def test_float_random_1d():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=10_000).astype(np.float32))
    for chunk in (256, 1024, 4096):
        _check(x, 10, chunk)


def test_ties_cross_chunk():
    # equal values spanning chunk boundaries: index order must match
    x = np.zeros(4096, np.float32)
    x[[5, 300, 1030, 2050, 4000]] = 7.0
    x[[6, 301, 1031]] = 7.0
    _check(jnp.asarray(x), 6, 1024)


def test_int_dtype_with_padding():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.integers(-(2**30), 2**30, size=3001, dtype=np.int32))
    _check(x, 7, 512)  # 3001 % 512 != 0 -> pad path


def test_batched_rows():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(5, 8192)).astype(np.float32))
    _check(x, 10, 1024)


def test_neg_inf_rows():
    x = jnp.full(5000, -jnp.inf, jnp.float32)
    got_v, _ = _tournament(x, 10, 512)
    assert np.all(np.isneginf(np.asarray(got_v)))


def test_small_input_passthrough():
    x = jnp.asarray(np.arange(64, dtype=np.float32))
    _check(x, 10, 1 << 20)
    ref_v, ref_i = lax.top_k(x, 10)
    got_v, got_i = wide_top_k(x, 10, chunk=1 << 20)
    np.testing.assert_array_equal(np.asarray(ref_v), np.asarray(got_v))
    np.testing.assert_array_equal(np.asarray(ref_i), np.asarray(got_i))


def _uses_tournament(shape, k):
    import jax

    jaxpr = jax.make_jaxpr(lambda v: wide_top_k(v, k))(
        jnp.zeros(shape, jnp.float32)
    )
    return "top_k[" not in str(jaxpr)


def test_narrow_rows_take_lax_top_k():
    """Row maxima and candidate lists (< 2^18 lanes) use XLA's TopK."""
    assert not _uses_tournament((40960,), 200)
    assert not _uses_tournament((32, 8192), 20)


def test_wide_rows_take_the_tournament():
    """The [nd] doc axis of a 1M-doc segment uses the tournament."""
    assert _uses_tournament((1 << 20,), 10)
    assert _uses_tournament((4, 1 << 20), 100)


def test_wide_row_matches_lax_top_k():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=1 << 18).astype(np.float32))
    assert _uses_tournament(x.shape, 12)
    ref_v, ref_i = lax.top_k(x, 12)
    got_v, got_i = wide_top_k(x, 12)
    np.testing.assert_array_equal(np.asarray(ref_v), np.asarray(got_v))
    np.testing.assert_array_equal(np.asarray(ref_i), np.asarray(got_i))
