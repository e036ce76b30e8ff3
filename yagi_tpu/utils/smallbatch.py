"""Small-batch padding for feedback-scan objects.

A 1-D channel batch with C < 8 channels compiles the per-step scan body of
the XLA route into near-scalar ops. Padding the batch to 8 channels
(edge-replicated so the dead channels follow sane dynamics — zero-padding
would starve the AGC/LMS normalizers) and slicing the outputs back keeps the
body vectorized without changing any real channel's results: every op in
the scan bodies is per-channel elementwise, so replicated channels never
couple back. Whether this still pays on the GPU is not measured.

Used internally by Symsync.execute_slots and QamRx.step_masked; the public
API shapes are unchanged.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["MIN_LANES", "pad_fields", "take_fields"]

MIN_LANES = 8


def pad_fields(obj, names, pad: int):
    """Edge-pad the leading (batch) axis of the named pytree fields."""
    upd = {}
    for nm in names:
        v = getattr(obj, nm)
        cfg = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
        upd[nm] = jnp.pad(v, cfg, mode="edge")
    return obj.replace(**upd)


def take_fields(obj, names, c: int):
    """Slice the leading (batch) axis of the named fields back to ``c``."""
    return obj.replace(**{nm: getattr(obj, nm)[:c] for nm in names})
