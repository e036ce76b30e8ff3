"""Valid-prefix compaction of masked emission buffers.

Feedback loops (symsync, QamRx) emit fixed-capacity slot buffers with a
validity mask; the liquid-style public APIs (symsync.rs:219 ``execute``,
symtrack ``execute``) return the valid samples front-compacted with a count.
No reference counterpart for the algorithm itself — the reference is
sequential host code where compaction is free; on a device it is a real
data movement pass and its formulation matters:

* ``sort`` (default): single stable ``lax.sort`` with the invalidity flag
  as key and the value planes as payload operands. O(N log² N) bitonic but
  ONE fused pass — no separate argsort + index gather.
* ``argsort``: argsort + take_along_axis.
* ``scatter``: destination index = cumsum(valid)−1, one ``put_along_axis``
  scatter into a capacity+1 buffer. O(N) on paper.

All three give bit-identical outputs; which is fastest on the GPU is not
measured.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["compact_valid"]


def compact_valid(y, v, method: str = "sort"):
    """Front-compact the entries of ``y`` where ``v`` is True (last axis).

    Returns ``(y_compacted, count)``: ``y_compacted[..., :count]`` holds the
    valid entries in stream order, the tail is zeroed. Works for real,
    complex, and integer ``y``.
    """
    v = jnp.asarray(v)
    n = y.shape[-1]
    count = jnp.sum(v.astype(jnp.int32), axis=-1)
    if method == "scatter":
        dst = jnp.cumsum(v.astype(jnp.int32), axis=-1) - 1
        dst = jnp.where(v, dst, n)  # invalid → overflow bin
        out = jnp.zeros(y.shape[:-1] + (n + 1,), dtype=y.dtype)
        out = jnp.put_along_axis(out, dst, y, axis=-1, inplace=False)
        return out[..., :n], count
    if method == "sort":
        key = (~v).astype(jnp.int32)
        if jnp.issubdtype(y.dtype, jnp.complexfloating):
            _, yr, yi = jax.lax.sort(
                (key, jnp.real(y), jnp.imag(y)), dimension=-1,
                is_stable=True, num_keys=1,
            )
            ys = jax.lax.complex(yr, yi)
        else:
            _, ys = jax.lax.sort(
                (key, y), dimension=-1, is_stable=True, num_keys=1
            )
        live = jnp.arange(n) < count[..., None]
        return jnp.where(live, ys, 0), count
    if method == "argsort":
        order = jnp.argsort(~v, axis=-1, stable=True)
        ys = jnp.take_along_axis(y, order, axis=-1)
        live = jnp.arange(n) < count[..., None]
        return jnp.where(live, ys, 0), count
    raise ValueError(f"unknown compaction method: {method}")
