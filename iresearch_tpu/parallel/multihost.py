"""Multi-host dryrun — the shard_map program across processes.

SURVEY §2.11 item 1 specifies "multi-host with the same collective".
The library's sharded execution is mesh-shape agnostic:
`ShardedSearcher` only sees a `jax.sharding.Mesh`, and the `all_gather`
merge in `_sharded_topk_batch` compiles to a cross-process collective
unchanged when the mesh spans processes. This module proves it end to
end without multi-host hardware: N local processes, each with K virtual
CPU devices, join one `jax.distributed` cluster (gloo CPU collectives
stand in for the network) and run the SAME `prepare_many` search over
the global mesh, validating against the host oracle in every process.

It is the only place the library starts processes, and every worker
forces the CPU backend: a JAX process reserves most of a GPU's memory
when it first uses the card, so workers sharing a card would fail. On
GPUs one process drives all local cards (`ShardedSearcher` over
`jax.devices()`); a real multi-host run starts one process per host.

Run a worker:

    python -m iresearch_tpu.parallel.multihost --process-id I \
        --num-processes N --coordinator localhost:PORT \
        --devices-per-proc K

or drive the whole cluster via `dryrun_multihost()` (used by
`__graft_entry__.dryrun_multihost` and tests/test_multihost.py).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile


def _build_reader(num_docs: int, segments: int):
    """Deterministic corpus — every process builds identical segments
    (the multi-host analog of every host opening the same on-disk
    index generation; reference: directory_reader snapshot open)."""
    import numpy as np

    from iresearch_tpu.index.reader import DirectoryReader
    from iresearch_tpu.index.writer import (
        Field,
        IndexWriter,
        IndexWriterOptions,
    )
    from iresearch_tpu.store.directory import MemoryDirectory

    words = [
        "alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
        "theta", "iota", "kappa", "lam", "mu", "nu", "xi", "omicron", "pi",
    ]
    rng = np.random.default_rng(7)
    d = MemoryDirectory()
    per_seg = max(1, num_docs // segments)
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(num_docs):
            n = int(rng.integers(3, 24))
            idx = np.minimum(rng.zipf(1.5, size=n) - 1, len(words) - 1)
            w.insert(
                [
                    Field(
                        "body",
                        " ".join(words[j] for j in idx),
                        analyzer="segmentation",
                    )
                ]
            )
            if (i + 1) % per_seg == 0 and segments > 1:
                w.commit()
        w.commit()
    return DirectoryReader.open(d)


def run_worker(
    process_id: int,
    num_processes: int,
    coordinator: str,
    devices_per_proc: int,
) -> None:
    """One process of the multi-host dryrun cluster.

    Initializes jax.distributed over the coordinator, builds the shared
    corpus, shards it over the GLOBAL mesh (process-spanning axis), and
    runs the batched sharded search — asserting exact oracle parity
    locally (outputs are replicated, so every process can check)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", devices_per_proc)
    try:  # cross-process CPU collectives (the DCN stand-in)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    n_global = num_processes * devices_per_proc
    devices = jax.devices()
    assert len(devices) == n_global, (len(devices), n_global)
    assert jax.process_count() == num_processes

    import numpy as np

    from iresearch_tpu.parallel import ShardedSearcher, make_mesh
    from iresearch_tpu.search import filters as F
    from iresearch_tpu.search.host_eval import search as host_search
    from iresearch_tpu.search.scorers import BM25

    reader = _build_reader(num_docs=192 * n_global, segments=n_global)
    mesh = make_mesh(devices)
    searcher = ShardedSearcher(list(reader.segments), mesh)
    assert searcher._multiproc, "mesh must span processes"
    queries = [
        F.ByTerm("body", "alpha"),
        F.Or(
            *[F.ByTerm("body", w) for w in ("alpha", "beta", "gamma", "delta")]
        ),
        F.Or(
            F.ByTerm("body", "alpha"),
            F.ByTerm("body", "beta"),
            F.ByTerm("body", "gamma"),
            min_match=2,
        ),
        F.And(F.ByTerm("body", "alpha"), F.ByTerm("body", "beta")),
    ]
    prep = searcher.prepare_many(queries, BM25(), wand=True)
    got = prep.top_k(5)
    for q, hits in zip(queries, got):
        want = host_search(reader, q, k=5)
        assert [h[0] for h in hits] == [e[0] for e in want], (q, hits, want)
        for (gd, gv), (wd, wv) in zip(hits, want):
            assert abs(gv - wv) <= 1e-5 * max(1.0, abs(wv)), (q, hits, want)
    # keep stdout greppable by the launcher
    print(f"MULTIHOST_OK process={process_id}/{num_processes} "
          f"devices={n_global} queries={len(queries)}", flush=True)


def dryrun_multihost(
    num_processes: int = 2, devices_per_proc: int = 4, timeout: int = 600
) -> None:
    """Spawn the worker cluster and require every process to pass.

    The same `_sharded_topk_batch` program body runs unchanged — the
    all_gather merge rides gloo across process boundaries exactly as it
    would ride the network between hosts."""
    import socket

    with socket.socket() as s:  # free localhost port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coordinator = f"localhost:{port}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the worker forces cpu itself
    procs = []
    logs = []
    for pid in range(num_processes):
        log = tempfile.NamedTemporaryFile(
            mode="w+", suffix=f".mh{pid}.log", delete=False
        )
        logs.append(log)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    "-m",
                    "iresearch_tpu.parallel.multihost",
                    "--process-id", str(pid),
                    "--num-processes", str(num_processes),
                    "--coordinator", coordinator,
                    "--devices-per-proc", str(devices_per_proc),
                ],
                stdout=log,
                stderr=subprocess.STDOUT,
                env=env,
            )
        )
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
        os.unlink(log.name)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "MULTIHOST_OK" not in out:
            raise RuntimeError(
                f"multihost worker {pid} failed (rc={p.returncode}):\n"
                + out[-4000:]
            )
    print(
        f"dryrun_multihost OK: {num_processes} processes x "
        f"{devices_per_proc} devices, exact oracle parity in every process"
    )


def _main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    a = ap.parse_args()
    run_worker(
        a.process_id, a.num_processes, a.coordinator, a.devices_per_proc
    )


if __name__ == "__main__":
    _main()
