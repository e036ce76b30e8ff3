"""Fused receive chain (one Triton kernel on the GPU, planar I/O).

Same DSP as :class:`yagi_tpu.chains.RxChain` — 64-tap kaiser FIR lowpass →
P× polyphase interpolating resampler (u32 phase, resamp.rs:141-154) → NCO
mix-down (osc.rs:179) — specialized to integer rates so the whole chain runs
as ONE kernel that reads the input stream once (kernels/chain.py).

State is 128 samples of raw input history (from which both the FIR window,
firfilt.rs:220, and the resampler's PFB window are implied) plus the u32 NCO
phase. The resampler phase accumulator is identically 0 at every block edge
because step·P = 2^24 exactly.

``backend="auto"`` takes the kernel on a GPU and the plain XLA formulation
of the same combined filter (:func:`~yagi_tpu.kernels.chain.chain_reference`)
elsewhere. I/O is planar (re/im f32); ``step`` offers a complex wrapper.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from .. import design
from ..errors import ConfigError
from ..filter.firpfb import pfb_decompose
from ..kernels import BACKENDS, use_kernel
from ..kernels.chain import HIST, chain_reference, chain_taps, fused_chain_apply
from ..nco import Osc

__all__ = ["FusedRxChain"]


@struct.pytree
class FusedRxChain:
    """Fused firfilt→resamp(P×)→mix_down chain state."""

    p: int = struct.static_field()  # integer interpolation rate
    backend: str = struct.static_field()  # "auto" | "xla" | "triton"
    interpret: bool = struct.static_field()  # Pallas interpret mode (tests)
    g: jnp.ndarray = struct.field()  # [K, P] combined chain filters
    hist_r: jnp.ndarray = struct.field()  # [C, 128] input history planes
    hist_i: jnp.ndarray = struct.field()
    theta: jnp.ndarray = struct.field()  # u32 NCO phase
    d_theta: jnp.ndarray = struct.field()  # u32 NCO frequency

    @classmethod
    def create(
        cls,
        n_taps: int = 64,
        fc: float = 0.2,
        as_: float = 60.0,
        rate: float = 2.0,
        mix_freq: float = 0.35,
        m: int = 7,
        npfb: int = 256,
        batch_shape: tuple = (),
        backend: str = "auto",
        interpret: bool = False,
    ) -> "FusedRxChain":
        p = int(round(rate))
        if p != rate or p < 1:
            raise ConfigError("FusedRxChain requires an integer rate")
        if npfb % p or (1 << 24) % p:
            raise ConfigError("rate must divide npfb and 2^24")
        if backend not in BACKENDS:
            raise ConfigError(f"unknown backend {backend!r}")
        # reference-parity designs, all host-side numpy (jit-safe)
        h_fir = design.fir_design_kaiser(n_taps, fc, as_, 0.0)
        n = 2 * m * npfb + 1
        hf = design.fir_design_kaiser(n, 0.25 / npfb, as_, 0.0)
        h_pfb = (hf * (npfb / np.sum(hf))).astype(np.float32)
        branches = pfb_decompose(h_pfb[: n - 1], npfb)
        g = chain_taps(h_fir, 2.0 * fc, branches, p)
        if len(batch_shape) != 1:
            raise ConfigError("FusedRxChain takes batch_shape=(channels,)")
        c = batch_shape[0]
        osc = Osc.create("exact").set_frequency(mix_freq)
        return cls(
            p=p,
            backend=backend,
            interpret=interpret,
            g=jnp.asarray(g),
            hist_r=jnp.zeros((c, HIST), jnp.float32),
            hist_i=jnp.zeros((c, HIST), jnp.float32),
            theta=osc.theta,
            d_theta=osc.d_theta,
        )

    def uses_kernel(self, block_len: int) -> bool:
        """Whether a block of ``block_len`` samples takes the kernel."""
        return use_kernel(self.backend, block_len > 0 and block_len % HIST == 0)

    # ------------------------------------------------------------- streaming
    def step_planar(self, xr, xi):
        """Planar block step: returns (yr, yi, num_valid, new_chain)."""
        t = xr.shape[-1]
        args = (xr, xi, self.g, self.hist_r, self.hist_i, self.theta,
                self.d_theta)
        if self.uses_kernel(t):
            yr, yi = fused_chain_apply(*args, interpret=self.interpret)
        else:
            yr, yi = chain_reference(*args)
        if t < HIST:
            xr = jnp.concatenate([self.hist_r, xr], axis=-1)
            xi = jnp.concatenate([self.hist_i, xi], axis=-1)
        new = self.replace(
            hist_r=xr[:, -HIST:],
            hist_i=xi[:, -HIST:],
            theta=self.theta + jnp.uint32(t * self.p) * self.d_theta,
        )
        return yr, yi, jnp.int32(t * self.p), new

    def step(self, x):
        """Complex convenience wrapper around :meth:`step_planar`."""
        x = jnp.asarray(x)
        yr, yi, k, new = self.step_planar(
            jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)
        )
        return jax.lax.complex(yr, yi), k, new

    __call__ = step
