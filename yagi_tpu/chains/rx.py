"""Baseline receive chain: FIR lowpass → arbitrary resampler → NCO mix.

This is BASELINE.json config[0] ("64-tap firfilt low-pass + resamp 2x + NCO
mix") packaged as one pytree with a jittable step. Per-stage semantics match
the reference objects (firfilt.rs, resamp.rs, osc.rs); the chain carries all
stream state so consecutive step() calls are bit-equal to one long run.
"""

from __future__ import annotations

import jax.numpy as jnp

from .._src import struct
from ..filter import FirFilter, Resamp
from ..nco import Osc

__all__ = ["RxChain"]


@struct.pytree
class RxChain:
    """firfilt → resamp → mix_down chain state."""

    fir: FirFilter = struct.field()
    resamp: Resamp = struct.field()
    osc: Osc = struct.field()

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
        osc_mode: str = "exact",
    ) -> "RxChain":
        fir = FirFilter.create_kaiser(
            n_taps, fc, as_, 0.0, batch_shape=batch_shape, dtype=jnp.complex64
        ).set_scale(2 * fc)
        rs = Resamp.create(rate, m=m, npfb=npfb, batch_shape=batch_shape)
        osc = Osc.create(osc_mode).set_frequency(mix_freq)
        return cls(fir=fir, resamp=rs, osc=osc)

    def step(self, x) -> tuple[jnp.ndarray, jnp.ndarray, "RxChain"]:
        """Process one block: returns (y, num_valid, new_chain).

        The resample and mix stages run through the fused
        ``execute_block_mix_down`` path (one XLA fusion instead of a second
        pass over the 2×-rate stream in device memory); bit-identical to the unfused execute_block + mix_block_down_n.
        """
        y0, fir = self.fir.execute_block(x)
        y2, k, rs, osc = self.resamp.execute_block_mix_down(y0, self.osc)
        return y2, k, self.replace(fir=fir, resamp=rs, osc=osc)

    __call__ = step
