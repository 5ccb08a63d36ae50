"""Device query execution.

The reference executes queries as pull-based scored iterator trees
(core/search/filter.hpp:62-78, conjunction.hpp, disjunction.hpp). The
device executor instead compiles a filter into a dense *block-scan plan*
(exec/plan.py) and runs it as one jitted XLA program per plan signature
(exec/executor.py): gather postings blocks, decode via cumsum, score on the
VPU, scatter-add into per-leaf dense doc arrays, fold the boolean tree
elementwise, finish with `jax.lax.top_k`.
"""

from iresearch_tpu.exec.executor import DeviceQuery, search_device

__all__ = ["DeviceQuery", "search_device"]
