"""Multi-chip parallelism: device mesh, sharded retrieval, collective stats.

Design (SURVEY.md §2.7, §5): the corpus shards over a 1-D "corpus" mesh axis
(optionally x a "data" axis for query batches); each chip computes its local
top-k; an all-gather merges the per-shard candidates; global df/avgdl
stats at index-build time reduce via psum. No KV-style cross-shard dependence
exists in retrieval, so no ring/Ulysses machinery is needed.
"""

from openintel_tpu.parallel.mesh import make_mesh  # noqa: F401
from openintel_tpu.parallel.sharded import (  # noqa: F401
    sharded_dense_topk,
    sharded_hybrid_topk,
)
