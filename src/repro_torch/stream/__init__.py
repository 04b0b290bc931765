"""repro_torch.stream — incremental snapshot maintenance + streaming DF-P.

The batch-update lifecycle as a subsystem: `delta` canonicalizes Δ^t,
`snapshot` maintains both device-resident hybrid layouts in place (row
scatters through the `scatter_rows` CUDA kernel), `session` chains DF-P
across batches, `replay` drives workloads with per-batch latency
accounting; `sharded` maintains one rank's shard of the partitioned
layout for the session's mesh mode. The JAX package's `repro.stream`.
"""
from .delta import Delta, ingest, next_pow2
from .snapshot import CapacityError, DeviceSnapshot, SnapshotStats
from .sharded import ShardedSnapshot
from .session import BatchStats, StreamSession, choose_engine, \
    frontier_estimate
from .replay import ReplayRecord, replay, churn_workload, mixed_workload

__all__ = [
    "Delta", "ingest", "next_pow2",
    "CapacityError", "DeviceSnapshot", "SnapshotStats", "ShardedSnapshot",
    "BatchStats", "StreamSession", "choose_engine", "frontier_estimate",
    "ReplayRecord", "replay", "churn_workload", "mixed_workload",
]
