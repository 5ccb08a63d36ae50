"""Driver contract: __graft_entry__.entry() jits; dryrun_multichip(8) runs."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_jits():
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    fn, args = g.entry()
    vals, docs = jax.jit(fn)(*args)
    assert vals.shape == (10,)
    assert docs.shape == (10,)
    assert float(vals[0]) > 0


def test_dryrun_multichip():
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dryrun_multichip_raises_on_accelerator_without_devices(monkeypatch):
    """On a started non-CPU backend with too few devices there is no
    fallback to the CPU: the dry run raises."""
    import jax
    from jax._src import xla_bridge

    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(xla_bridge, "backends_are_initialized", lambda: True)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [FakeGpu()])
    with pytest.raises(RuntimeError, match="needs 4 devices; the gpu backend has 1"):
        g.dryrun_multichip(4)
    assert jax.config.jax_platforms == "cpu"  # nothing was switched


def test_dryrun_multichip_raises_on_small_cpu_backend():
    """A CPU backend already sized below the request is not resized."""
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"needs {n} devices; the cpu backend"):
        g.dryrun_multichip(n)
