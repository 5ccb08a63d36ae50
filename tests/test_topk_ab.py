"""scripts/topk_ab.py at a tiny size on the CPU: both routings agree, and
the shipped routing and the compile-cache setting are restored."""

import os
import sys

import jax

from iresearch_tpu.ops import topk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import topk_ab  # noqa: E402


def test_ab_variants_agree(capsys):
    shipped = topk._MIN_WIDTH
    before = jax.config.jax_enable_compilation_cache
    try:
        assert topk_ab.main(
            ["--docs", "2000", "--per-category", "1", "--order", "routed,tournament"]
        ) == 0
    finally:
        jax.config.update("jax_enable_compilation_cache", before)
    assert topk._MIN_WIDTH == shipped
    out = capsys.readouterr().out
    assert "[tournament] mix k=100" in out
    assert "agree with routed's" in out
