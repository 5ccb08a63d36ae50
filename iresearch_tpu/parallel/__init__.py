"""Scale-out: segment sharding over a device mesh.

The reference is a single-process library — distribution lives in the
embedding database above it (SURVEY.md §2.11). This framework
makes sharding first-class: segments are placed along a 1-D ``jax.sharding
.Mesh`` axis, a query executes on every shard via ``shard_map`` (decode →
score → local top-k), and shards merge ``(score, global_doc)`` candidates
with an ICI ``all_gather`` + lexicographic re-rank — the collective-based
analog of the reference CLI's thread-per-query fan-out
(utils/index-search.cpp:718).
"""

from iresearch_tpu.parallel.sharded import ShardedSearcher, make_mesh

__all__ = ["ShardedSearcher", "make_mesh"]
