"""Unconjugated inner product (the reference's dotprod trait).

Behavioral spec: /root/reference/src/dotprod/mod.rs:13-17 — sum(a[i]·b[i])
with NO conjugation for any of the rrrf/rcc/crc/ccc type combinations. In
this framework the hot paths never call this directly (streaming filters run
the banded-matmul formulations in filter/_conv.py); it exists as the public
building block and semantic anchor.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["dotprod"]


def dotprod(a, b):
    """sum(a·b), unconjugated (dotprod/mod.rs:13-17)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    return jnp.sum(a * b, axis=-1)
