"""Multi-host streaming distribution.

The reference is a single-threaded library (SURVEY.md §2.7); this layer is
the scale-out path: each host feeds its local time blocks of the
sample stream, a global ``Mesh`` spans all hosts' devices, and the same
``shard_map`` streaming kernels (ppermute halo exchange, all_to_all channel
redistribution) run unchanged — XLA routes the shard-boundary collectives
over the intra-host links within a host and the network across hosts.

Wiring order on every process (see tools/multihost_worker.py for the
runnable pattern, testable on CPU with 2 processes):

    initialize_multihost(coordinator, num_processes, process_id)
    mesh  = global_time_mesh()
    xg    = distribute_time_stream(x_local, mesh)   # per-host blocks → global
    y     = time_sharded_fir(h, xg, mesh)           # or any sharded kernel
    y_all = gather_to_hosts(y)                      # replicated numpy result
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize_multihost",
    "global_time_mesh",
    "distribute_time_stream",
    "gather_to_hosts",
]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> None:
    """Join the JAX distributed runtime (idempotent).

    With no arguments, JAX's cluster autodetection applies; explicit
    arguments (coordinator address, process count and id) support generic
    clusters and the 2-process CPU conformance test. Safe to call twice.
    """
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def global_time_mesh(ch: int = 1) -> Mesh:
    """('ch', 'time') mesh over ALL devices of ALL processes.

    Device order follows ``jax.devices()`` (process-major), so consecutive
    time shards land on one host first — halo ppermutes cross the network only once
    per host boundary.
    """
    devices = np.asarray(jax.devices())
    n = len(devices)
    if ch > 1 and n % ch == 0:
        shape = (ch, n // ch)
    else:
        shape = (1, n)
    return Mesh(devices.reshape(shape), ("ch", "time"))


def distribute_time_stream(x_local: np.ndarray, mesh: Mesh) -> jax.Array:
    """Assemble the global [ch, time] stream from per-process local blocks.

    Each process passes the contiguous time block it ingested (e.g. from its
    antenna front-end); the result is one global array time-sharded over the
    mesh without any cross-host data movement.
    """
    sharding = NamedSharding(mesh, P(None, "time"))
    return jax.make_array_from_process_local_data(sharding, np.asarray(x_local))


def gather_to_hosts(y: jax.Array) -> np.ndarray:
    """Gather a sharded result to every host as numpy (cross-host allgather)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(y, tiled=True))
