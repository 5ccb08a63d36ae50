"""chip_smoke.py's checks at a tiny size on the CPU, called directly
(its ``main`` refuses any device but a GPU)."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


WANT = [(7, 3.0), (2, 2.5), (9, 2.5), (4, 1.0)]


def test_compare_equal_lists():
    assert cs.compare_topk(list(WANT), WANT, k=4) == []


def test_compare_score_mismatch():
    got = [(7, 3.0), (2, 2.5), (9, 2.5), (4, 1.1)]
    assert cs.compare_topk(got, WANT, k=4) == ["rank 3: score 1.1, oracle 1.0"]


def test_compare_tie_swap_allowed():
    got = [(7, 3.0), (9, 2.5 * (1 + 5e-6)), (2, 2.5), (4, 1.0)]
    assert cs.compare_topk(got, WANT, k=4) == []


def test_compare_non_tie_swap_rejected():
    got = [(2, 3.0), (7, 2.5), (9, 2.5), (4, 1.0)]
    probs = cs.compare_topk(got, WANT, k=4)
    assert any("in place of doc 7" in p for p in probs), probs


def test_compare_boundary_tie_stand_in():
    """A doc tied with the k-th may replace it; an untied one may not."""
    got = [(7, 3.0), (2, 2.5), (9, 2.5), (5, 1.0)]
    assert cs.compare_topk(got, WANT, k=4) == []
    got = [(7, 3.0), (2, 2.5), (9, 2.5), (5, 0.5)]
    probs = cs.compare_topk(got, WANT, k=4)
    assert any("not in the oracle" in p for p in probs)
    assert any("oracle doc 4" in p for p in probs)


def test_compare_short_list_needs_every_match():
    """Fewer matches than k: the matched doc sets must be equal."""
    want = WANT[:3]
    got = [(7, 3.0), (2, 2.5), (5, 2.5)]
    probs = cs.compare_topk(got, want, k=10)
    assert any("oracle doc 9" in p for p in probs)
    assert cs.compare_topk(WANT[:2], want, k=10) == ["2 hits, oracle has 3"]


def test_hits_of_drops_non_matches():
    vals = np.asarray([2.0, 1.0, -np.inf], np.float32)
    docs = np.asarray([5, 3, 0], np.int32)
    assert cs.hits_of(vals, docs) == [(5, 2.0), (3, 1.0)]


def test_missing_tiers():
    assert cs.missing_tiers({}) == list(cs.TIERS)
    every = {0: set(cs.TIERS[:4]), 1: set(cs.TIERS[4:])}
    assert cs.missing_tiers(every) == []
    assert cs.missing_tiers({0: {"dense", "scan"}}) == [
        t for t in cs.TIERS if t not in ("dense", "scan")
    ]


def test_main_refuses_cpu():
    import jax

    before = jax.config.jax_compilation_cache_dir
    try:
        with pytest.raises(cs.SmokeFailure, match="needs a GPU"):
            cs.main([])
    finally:
        # main() points the compile cache at its directory first
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture(scope="module")
def tiny_index():
    return cs.phase_ingest(3000, 7, 2)


def test_ingest_builds_segments(tiny_index):
    assert len(tiny_index.segments) == 2
    assert sum(sr.num_docs for sr in tiny_index.segments) == 3000


def test_categories_cover_the_mix(tiny_index):
    cats = cs.category_queries(tiny_index, 2)
    assert set(cats) == {
        "HighTerm", "MedTerm", "LowTerm", "AndHighHigh", "AndHighMed",
        "AndHighLow", "OrHighMed", "OrHigh4", "OrMed4", "MinMatch2High2Med",
        "Phrase", "Prefix", "Fuzzy1",
    }
    assert all(len(qs) == 2 for qs in cats.values())


@pytest.mark.parametrize("k", [10, 100])
def test_batch_matches_oracle_with_tiers(tiny_index, k):
    """The smoke's batched comparison and tier reading, end to end."""
    from iresearch_tpu.exec.batch import QueryBatch
    from iresearch_tpu.search.scorers import BM25

    cats = cs.category_queries(tiny_index, 1)
    queries = [q for qs in cats.values() for q in qs]
    want = cs.oracle(tiny_index, queries, (k,))[k]
    mb = QueryBatch(
        queries, list(tiny_index.segments), BM25(), wand=True
    ).prepare_all(k)
    tiers = cs.batch_tiers(mb)
    assert sorted(tiers) == list(range(len(queries)))
    assert all(t and t <= set(cs.TIERS) for t in tiers.values())
    vals, docs = (np.asarray(a) for a in mb.run())
    for qi in range(len(queries)):
        assert cs.compare_topk(cs.hits_of(vals[qi], docs[qi]), want[qi], k) == []


def test_kernel_phase_at_tiny_shapes(capsys):
    cs.phase_kernels("cpu", 3, sizes=(9000,))
    out = capsys.readouterr().out
    assert out.count("[kernels] top-k") == 6
    assert out.count("picks lax.top_k") == 6  # 9216-lane rows are narrow


def test_four_cards_phase_on_virtual_devices():
    """The committed --four-cards phase on four virtual CPU devices:
    sharded results equal the oracle and the one-card batch. It runs in
    a process of its own, with four devices, as on four cards."""
    import subprocess

    code = (
        "import sys, jax; sys.path.insert(0, %r); import chip_smoke as cs; "
        "assert len(jax.devices()) == 4; "
        "r = cs.phase_ingest(3000, 11, 4); assert len(r.segments) == 4; "
        "cs.phase_four_cards(r, 1, 'cpu', jax.devices())" % REPO
    )
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    r = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    assert "all 13 queries match the oracle and the one-card QueryBatch" in r.stdout
