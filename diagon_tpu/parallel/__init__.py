"""Multi-device parallelism: segment shards over a jax.sharding.Mesh.

The reference is single-process; its per-leaf search loop
(``IndexSearcher.cpp:76``) and docBase merge are the seam (SURVEY.md
section 2.13). Here each device holds one segment shard; queries execute
per-shard with the same kernels as single-device, and per-shard top-k
results merge on-device with ``all_gather``.
"""

from diagon_tpu.parallel.sharded import ShardedSearcher  # noqa: F401
