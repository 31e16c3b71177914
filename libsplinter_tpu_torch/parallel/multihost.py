"""Multi-process (multi-host) bootstrap and host-local store conventions
— the counterpart of the JAX package's parallel/multihost.py.

Every worker runs its own host-local store under the same bus name and
serves its local clients over shared memory exactly as one host does;
the workers meet in one ``torch.distributed`` process group.  The
group is ``gloo``: it carries host-side control only — counts, shared
bucket sizes, candidate lists and key bytes (parallel/sharded_search
PodSearch) — while device data stays on each worker's cards.

``init_distributed()`` is idempotent and a no-op in a single process,
so daemons can call it unconditionally.
"""
from __future__ import annotations

import os

import torch.distributed as dist

_initialized = False


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join this process to the workers' gloo group.

    Arguments default from torch's standard environment: the
    coordinator from MASTER_ADDR and MASTER_PORT (as
    ``tcp://ADDR:PORT``), the process count from WORLD_SIZE and this
    process's id from RANK.  Returns True when a multi-process group is
    up, False for the single-process fast path."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return dist.get_world_size() > 1
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    num = num_processes if num_processes is not None else \
        int(os.environ.get("WORLD_SIZE", "0") or 0)
    pid = process_id if process_id is not None else \
        int(os.environ.get("RANK", "-1") or -1)
    if num <= 1:
        return False        # one process, nothing to wire
    if coordinator is None:
        raise ValueError("a multi-process group needs its coordinator "
                         "(coordinator= or MASTER_ADDR/MASTER_PORT)")
    if pid < 0:
        raise ValueError("a multi-process group needs this process's id "
                         "(process_id= or RANK)")
    dist.init_process_group("gloo", init_method=coordinator,
                            world_size=num, rank=pid)
    _initialized = True
    return num > 1


def host_store_name(base: str) -> str:
    """Host-local bus name: identical on every worker by convention, so
    one deployment manifest serves them all (shared memory is per host,
    so the stores never collide)."""
    return base


def process_span() -> tuple[int, int]:
    """(process_id, process_count) of this worker."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
