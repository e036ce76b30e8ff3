"""Multi-device streaming: time-block sharding with overlap-save halo exchange.

No reference equivalent (the reference is single-threaded; SURVEY.md §2.7).
This is the distribution layer: a continuous sample stream is laid
out as [channels, time] with channels sharded across one mesh axis and time
blocks across another. Causal filters need the last L-1 samples of the
previous time block — the "halo" — which each device receives from its left
neighbor via a single `jax.lax.ppermute` before running its local
convolution. Output is bit-identical to the same per-block computation run
sequentially on one device, because each device computes exactly the same
concat(history, block) convolution it would locally.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "halo_exchange_left",
    "time_sharded_fir",
    "make_stream_mesh",
]


def make_stream_mesh(n_devices: int | None = None, ch: int = 1):
    """Mesh with ('ch', 'time') axes over the available devices."""
    devices = np.asarray(jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if ch > 1 and n % ch == 0:
        shape = (ch, n // ch)
    else:
        shape = (1, n)
    return Mesh(devices.reshape(shape), ("ch", "time"))


def halo_exchange_left(block: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Return the last ``halo`` samples of the LEFT neighbor's block.

    Device 0 receives zeros (stream start). Single ppermute.
    """
    tail = block[..., block.shape[-1] - halo :]
    n = jax.lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]  # send right
    recv = jax.lax.ppermute(tail, axis_name, perm)
    idx = jax.lax.axis_index(axis_name)
    return jnp.where(idx == 0, jnp.zeros_like(recv), recv)


def time_sharded_fir(h, x, mesh: Mesh, history=None):
    """FIR-filter a [ch, time] stream sharded over a ('ch','time') mesh.

    Equivalent to FirFilter.create(h, ...).execute_block(x) run on one
    device: each time shard gets its left halo via ppermute and runs a local
    VALID conv. ``history`` optionally seeds the stream-start history
    ([ch, L-1], placed on the first time shard).
    """
    from ..filter._conv import causal_conv_valid

    h = jnp.asarray(h)
    L = h.shape[0]

    def local(block, hist):
        halo = halo_exchange_left(block, L - 1, "time")
        idx = jax.lax.axis_index("time")
        lead = jnp.where(idx == 0, hist, halo)
        xa = jnp.concatenate([lead.astype(block.dtype), block], axis=-1)
        return causal_conv_valid(xa, h)

    if history is None:
        history = jnp.zeros(x.shape[:-1] + (L - 1,), dtype=x.dtype)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("ch", "time"), P("ch", None)),
        out_specs=P("ch", "time"),
    )
    return fn(x, history)
