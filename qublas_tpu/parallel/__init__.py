"""Multi-chip / multi-host parallelism (Mesh + shard_map + collectives).

The reference has no distribution (SURVEY.md §2.19); this package provides
the BASELINE-mandated sharded GEMM strategies.
"""

from .sharding import (
    init_distributed,
    make_mesh,
    shard_qgemul,
    sharded_cgemul,
    sharded_cgemul_dp,
    sharded_cgemul_k,
    sharded_cgemul_k_tree,
    sharded_cgemul_mn,
    sharded_qgemul_dp,
    sharded_qgemul_k,
    sharded_qgemul_k_limb,
    sharded_qgemul_k_limb_pipelined,
    sharded_qgemul_k_pipelined,
    sharded_qgemul_k_tree,
    sharded_qgemul_k_wide,
    sharded_qgemul_k_wide_pipelined,
    sharded_qgemul_mn,
    sharded_qreduce,
    sharded_qreduce_k,
    sharded_qreduce_k_tree,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "shard_qgemul",
    "sharded_cgemul",
    "sharded_cgemul_dp",
    "sharded_cgemul_k",
    "sharded_cgemul_k_tree",
    "sharded_cgemul_mn",
    "sharded_qgemul_dp",
    "sharded_qgemul_k",
    "sharded_qgemul_k_tree",
    "sharded_qgemul_k_limb",
    "sharded_qgemul_k_limb_pipelined",
    "sharded_qgemul_k_pipelined",
    "sharded_qgemul_k_wide",
    "sharded_qgemul_k_wide_pipelined",
    "sharded_qgemul_mn",
    "sharded_qreduce",
    "sharded_qreduce_k",
    "sharded_qreduce_k_tree",
]
