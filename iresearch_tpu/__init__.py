"""iresearch_tpu — an accelerator-native full-text search engine.

A from-scratch rebuild of the capabilities of IResearch (the C++ Lucene-like
library behind ArangoSearch; reference layout: ``core/{store,formats,analysis,
index,search}``) designed for accelerator hardware:

* Postings live in HBM as width-classed ``[rows, 128]`` block pools; decode is
  a vectorized gather + per-block prefix-sum (VPU work), not pointer chasing.
* Query execution is dense doc-axis dataflow: leaves scatter-add scores and
  match counts into ``[num_docs]`` arrays, boolean combinators are elementwise
  ops that XLA fuses into a single pass, and exact top-k finishes the query.
* The host side (term dictionaries, analyzers, commit machinery) mirrors the
  reference's single-writer / snapshot-reader semantics
  (reference: core/index/index_writer.hpp:181, core/store/directory.hpp:97).

Scale-out is segment sharding over a ``jax.sharding.Mesh`` with per-shard
top-k and an ICI all-gather merge (see ``iresearch_tpu.parallel``).
"""

__version__ = "0.1.0"

_LAZY = {
    "IndexWriter": ("iresearch_tpu.index.writer", "IndexWriter"),
    "IndexWriterOptions": ("iresearch_tpu.index.writer", "IndexWriterOptions"),
    "DirectoryReader": ("iresearch_tpu.index.reader", "DirectoryReader"),
    "Directory": ("iresearch_tpu.store.directory", "Directory"),
    "FSDirectory": ("iresearch_tpu.store.directory", "FSDirectory"),
    "MMapDirectory": ("iresearch_tpu.store.directory", "MMapDirectory"),
    "MemoryDirectory": ("iresearch_tpu.store.directory", "MemoryDirectory"),
}


def __getattr__(name):
    """Lazy top-level exports: keep `import iresearch_tpu` light (no jax)."""
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value


__all__ = [
    "IndexWriter",
    "IndexWriterOptions",
    "DirectoryReader",
    "Directory",
    "FSDirectory",
    "MMapDirectory",
    "MemoryDirectory",
    "__version__",
]
