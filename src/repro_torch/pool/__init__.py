"""`repro_torch.pool`: the master / worker block-task control plane of the
sharded fits.

It turns the fixed block -> shard placement of the lockstep executor into
leased, reassignable tasks: one worker thread per shard pulls blocks from a
central `TaskPool` with heartbeats, lease timeouts, failed-worker requeue,
straggler stealing and speculative backups, while a duplicate-dropping,
block-id-ordered host merge keeps the fit's labels those of the fault-free
run. `chaos` injects kills and delays.
"""
from repro_torch.pool.chaos import ChaosPlan, active, inject
from repro_torch.pool.executor import pool_map_reduce
from repro_torch.pool.tasks import Lease, TaskPool, WorkerKilled

__all__ = [
    "ChaosPlan",
    "Lease",
    "TaskPool",
    "WorkerKilled",
    "active",
    "inject",
    "pool_map_reduce",
]
