"""Multi-stage arbitrary resampler.

Behavioral spec: /root/reference/src/filter/resampler/msresamp.rs. The rate
is decomposed into halfband stages (bringing it into [0.5, 2]) plus one
arbitrary-rate stage (msresamp.rs:28-80). Interpolation runs arbitrary →
halfbands; decimation runs halfbands → arbitrary (msresamp.rs:129-164).

The composite is FULLY JITTABLE end-to-end (``execute_block``): the
arbitrary stage's data-dependent sample count threads through the halfband
chain via the valid-prefix convention — fixed-capacity buffers, traced
valid counts, stage windows extracted at the traced valid end with dynamic
slices (the Resamp fixed-capacity pattern, SURVEY.md §7 "hard parts" #2).
``execute`` is a host-compacting convenience wrapper.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from .resamp import Resamp
from .msresamp2 import MsResamp2

__all__ = ["MsResamp"]


@struct.pytree
class MsResamp:
    """Composite resampler state (msresamp.rs:10-20)."""

    rate: float = struct.static_field()
    interp: bool = struct.static_field()
    rate_arbitrary: float = struct.static_field()
    num_halfband_stages: int = struct.static_field()
    halfband: MsResamp2 = struct.field()
    arbitrary: Resamp = struct.field()
    # decim path: carried samples waiting to fill a 2^k group
    carry: jnp.ndarray = struct.field()  # [..., 2^k]
    carry_len: jnp.ndarray = struct.field()  # int32

    @classmethod
    def create(cls, rate: float, as_: float = 60.0, batch_shape: tuple = (),
               dtype=jnp.complex64, arbitrary_interp: str = "pfb") -> "MsResamp":
        """Rate decomposition per msresamp.rs:28-80.

        ``arbitrary_interp="farrow"`` puts the arbitrary stage on the
        gather-free fast path (filter/_farrow_resamp.py): exact u32 schedule, values
        within the reference's 1/256 branch-quantization floor.
        """
        if rate <= 0.0:
            raise ConfigError("resampling rate must be greater than zero")
        interp = rate > 1.0
        rate_arbitrary = rate
        num_hb = 0
        if interp:
            while rate_arbitrary > 2.0:
                num_hb += 1
                rate_arbitrary *= 0.5
        else:
            while rate_arbitrary < 0.5:
                num_hb += 1
                rate_arbitrary *= 2.0
        halfband = MsResamp2.create(
            interp, num_hb, 0.4, 0.0, as_, batch_shape=batch_shape, dtype=dtype
        )
        arbitrary = Resamp.create(
            rate_arbitrary,
            m=7,
            fc=min(0.515 * rate_arbitrary, 0.49),
            as_=as_,
            npfb=256,
            batch_shape=batch_shape,
            dtype=dtype,
            interp=arbitrary_interp,
        )
        return cls(
            rate=float(rate),
            interp=interp,
            rate_arbitrary=float(rate_arbitrary),
            num_halfband_stages=num_hb,
            halfband=halfband,
            arbitrary=arbitrary,
            carry=jnp.zeros(batch_shape + (1 << num_hb,), dtype=jnp.dtype(dtype)),
            carry_len=jnp.asarray(0, dtype=jnp.int32),
        )

    def reset(self) -> "MsResamp":
        return self.replace(
            halfband=self.halfband.reset(),
            arbitrary=self.arbitrary.reset(),
            carry=jnp.zeros_like(self.carry),
            carry_len=jnp.zeros_like(self.carry_len),
        )

    def get_rate(self) -> float:
        return self.rate

    def get_delay(self) -> float:
        """Composite delay (msresamp.rs:91-105)."""
        dh = self.halfband.get_delay()
        da = float(self.arbitrary.get_delay())
        if self.num_halfband_stages == 0:
            return da
        if self.interp:
            return dh / self.rate_arbitrary + da
        m = 1 << self.num_halfband_stages
        return dh + m * da

    def get_num_output(self, num_input: int) -> int:
        """Exact output count (msresamp.rs:113-124); host-side."""
        if self.interp:
            n = self.arbitrary.get_num_output(num_input)
            return n * (1 << self.num_halfband_stages)
        n = (int(np.asarray(self.carry_len)) + num_input) >> self.num_halfband_stages
        return self.arbitrary.get_num_output(n)

    def out_capacity(self, num_input: int) -> int:
        """Static output-buffer capacity for :meth:`execute_block`."""
        if self.interp:
            cap1 = self.arbitrary.out_capacity(num_input)
            return cap1 << self.num_halfband_stages
        m = 1 << self.num_halfband_stages
        cap1 = (num_input + m) >> self.num_halfband_stages
        return self.arbitrary.out_capacity(cap1)

    def execute_block(self, x) -> tuple[jnp.ndarray, jnp.ndarray, "MsResamp"]:
        """Fully jittable composite: returns (y, num_output, state) with y a
        fixed-capacity buffer, zeros beyond num_output (msresamp.rs:126-164).

        The variable-length stage hand-off uses the valid-prefix convention
        (Resamp.execute_block_n / MsResamp2.execute_block_n): buffers keep
        static shapes, the exact valid counts thread through as traced
        values, and stage windows land at the traced valid end — no host
        sync anywhere.
        """
        x = jnp.asarray(x)
        n = x.shape[-1]
        if self.interp:
            # arbitrary stage first (low rate), then halfband interp chain
            y1, k, arb = self.arbitrary.execute_block(x)
            y2, k2, hb = self.halfband.execute_block_n(y1, k)
            return y2, k2, self.replace(arbitrary=arb, halfband=hb)

        # decimation: compact carry+input into a valid-prefix buffer, group
        # into multiples of 2^k for the halfband chain, then arbitrary stage
        m = 1 << self.num_halfband_stages
        cl = self.carry_len
        capb = -(-(n + m) // m) * m  # static capacity, multiple of 2^k
        carry_pad = jnp.concatenate(
            [
                self.carry.astype(x.dtype),
                jnp.zeros(x.shape[:-1] + (capb - m,), dtype=x.dtype),
            ],
            axis=-1,
        )
        # place the new block starting at the carry's valid end (traced cl)
        xext = jnp.concatenate(
            [
                jnp.zeros(x.shape[:-1] + (m,), dtype=x.dtype),
                x,
                jnp.zeros(x.shape[:-1] + (capb - n,), dtype=x.dtype),
            ],
            axis=-1,
        )
        xshift = jax.lax.dynamic_slice_in_dim(xext, m - cl, capb, axis=-1)
        buf = jnp.where(jnp.arange(capb) >= cl, xshift, carry_pad)
        total = cl + n
        rem = total % m
        n_groups_samples = total - rem
        y1, k1, hb = self.halfband.execute_block_n(buf, n_groups_samples)
        y2, k2, arb = self.arbitrary.execute_block_n(y1, k1)
        # carry = the rem ungrouped samples at the valid end
        new_carry = jax.lax.dynamic_slice_in_dim(buf, n_groups_samples, m, axis=-1)
        new_carry = jnp.where(jnp.arange(m) < rem, new_carry, 0)
        return y2, k2, self.replace(
            halfband=hb,
            arbitrary=arb,
            carry=new_carry,
            carry_len=rem.astype(jnp.int32),
        )

    def execute(self, x) -> tuple[np.ndarray, "MsResamp"]:
        """Resample a block; host-compacted convenience wrapper around the
        jittable :meth:`execute_block` (msresamp.rs:126-164).

        Returns a COMPACT array of exactly get_num_output(len(x)) samples.
        Requires concrete (non-traced) state.
        """
        y, k, new = self.execute_block(x)
        return np.asarray(y)[..., : int(np.asarray(k))], new

    __call__ = execute
