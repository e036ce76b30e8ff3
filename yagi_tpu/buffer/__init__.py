"""Buffers: sliding window, delay line, circular buffer.

Behavioral spec: /root/reference/src/buffer/window.rs (power-of-2 shadowed
sliding window), /root/reference/src/buffer/wdelay.rs (fixed delay line).
``CBuffer`` fills the gap the reference left open
(/root/reference/src/buffer/mod.rs:1-5 "cbuffer missing") from liquid-dsp's
cbuffer semantics.

In this framework these host-side objects exist for API parity and for
host-side orchestration (framing, test harnesses). The *hot-path* analog is
the explicit window/state arrays every `yagi_tpu.filter` pytree carries:
a `Window` of length n is an `[..., n]` array rolled by `jnp.concatenate`
once per block, not per sample.
"""

from .buffer import CBuffer, WDelay, Window

__all__ = ["Window", "WDelay", "CBuffer"]
