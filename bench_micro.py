"""Microbenchmarks (reference analog: microbench/ google-benchmark suite —
column writer, crc, hash map, segmentation stream, simd utils).

Run: python bench_micro.py  (uses the accelerator for device ops; prints a
table to stdout, no driver contract).
"""

from __future__ import annotations

import time

import numpy as np


def timeit(fn, n=20, warmup=2):
    for _ in range(warmup):
        fn()
    t0 = time.time()
    for _ in range(n):
        fn()
    return (time.time() - t0) / n


def main():
    from iresearch_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(0)
    rows = []

    # bitpack pack/unpack (simd_utils/bit_packing analog)
    from iresearch_tpu.formats.bitpack import pack_blocks, unpack_blocks

    vals = rng.integers(0, 256, size=(4096, 128), dtype=np.uint64).astype(np.uint32)
    words = pack_blocks(vals, 8)
    rows.append(("pack_blocks b=8 (4096 blocks)", timeit(lambda: pack_blocks(vals, 8))))
    rows.append(("unpack_blocks b=8", timeit(lambda: unpack_blocks(words, 8))))

    # native tokenizer + termdict (segmentation stream + hash map analog)
    from iresearch_tpu.native import TermDict, load

    text = "the quick brown fox jumps over the lazy dog " * 40
    if load() is not None:
        def tok():
            d = TermDict()
            for _ in range(50):
                d.tokenize_to_tids(text, "lower", "alpha")
        rows.append(("native tokenize+tid 50x360tok", timeit(tok)))

    # crc (crc microbench analog)
    from iresearch_tpu.native import crc32c
    import zlib

    blob = rng.bytes(1 << 20)
    rows.append(("zlib.crc32 1MB", timeit(lambda: zlib.crc32(blob))))
    if crc32c(b"x") is not None:
        rows.append(("native crc32c 1MB", timeit(lambda: crc32c(blob))))

    # inversion (field_data::invert analog)
    from iresearch_tpu.index.invert import invert_numpy

    N = 500_000
    tids = rng.integers(0, 30_000, N)
    doc = np.sort(rng.integers(0, 10_000, N))
    pos = np.arange(N) % 64
    rows.append(
        ("invert_numpy 500k tokens", timeit(lambda: invert_numpy(tids, doc, pos, 30_000, 10_000), n=5))
    )

    # device decode + topk (postings reader analog)
    import jax
    import jax.numpy as jnp
    from iresearch_tpu.formats.bitpack import unpack_jnp

    dw = jnp.asarray(pack_blocks(vals, 8))

    @jax.jit
    def decode(dw):
        return unpack_jnp(dw, 8).astype(jnp.int32).cumsum(axis=1)

    decode(dw).block_until_ready()
    rows.append(("device decode 4096 blocks", timeit(lambda: decode(dw).block_until_ready())))

    x = jnp.asarray(rng.standard_normal(1 << 20).astype(np.float32))
    topk = jax.jit(lambda x: jax.lax.top_k(x, 10))
    topk(x)[0].block_until_ready()
    rows.append(("device top_k 1M", timeit(lambda: topk(x)[0].block_until_ready())))

    # WAND mode ladder (exact vs strict vs approx) on a prepared OR query
    # — the WandContext speed/recall knob (tests/test_wand_modes.py pins
    # semantics; this records the speed side)
    from iresearch_tpu.exec import DeviceQuery
    from iresearch_tpu.index.reader import DirectoryReader
    from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions
    from iresearch_tpu.search import filters as F
    from iresearch_tpu.store.directory import MemoryDirectory
    import iresearch_tpu.exec.plan as planmod

    words16 = [f"w{i:02d}" for i in range(40)]
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        bulk = rng.integers(0, len(words16), size=(20_000, 24))
        for row in bulk:
            w.insert([Field("body", " ".join(words16[j] for j in row),
                            analyzer="segmentation")])
        w.commit()
    r = DirectoryReader.open(d)
    flt = F.Or(*[F.ByTerm("body", f"w{i:02d}") for i in range(6)])
    old_join = planmod.JOIN_MAX_SPANS
    planmod.JOIN_MAX_SPANS = 0  # exercise the WAND body itself
    try:
        for mode in ("exact", "strict", "approx"):
            dq = DeviceQuery(flt, list(r.segments), wand=True,
                             wand_sample=8, wand_mode=mode)
            dq.execute_segment(0, 10)  # compile + upload
            rows.append(
                (f"wand 6-term OR 20k docs [{mode}]",
                 timeit(lambda dq=dq: dq.execute_segment(0, 10))),
            )
    finally:
        planmod.JOIN_MAX_SPANS = old_join

    # columnstore build (column writer analog)
    from iresearch_tpu.formats.columnstore import ColumnBuilder

    def col():
        cb = ColumnBuilder("c")
        for d in range(20_000):
            cb.add(d, b"value-%d" % d)
        cb.build(20_000)

    rows.append(("column build 20k docs", timeit(col, n=5)))

    w = max(len(n) for n, _ in rows)
    for name, t in rows:
        print(f"{name:<{w}}  {t*1e3:10.3f} ms")


if __name__ == "__main__":
    main()
