"""firpfbchr: arbitrary-rate polyphase channelizer analysis bank.

Fills part of the reference's unported multichannel layer (SURVEY.md §2.6:
``firpfbchr_crcf`` rows in LIQUID_COMPAT.md:1765-1798). Behavioral spec is
liquid-dsp's firpfbchr: M channels spaced 1/M apart, decimated by an
*arbitrary* factor P <= M (not tied to M as in firpfbch, or M/2 as in
firpfbch2): each step consumes P input samples and produces one output per
channel, so the per-channel output rate is fs/P — an oversampled
channelizer whenever P < M.

Block-parallel: a step-t output is the M-point DFT-bank response of the
prototype window ending at the newest sample, evaluated for ALL steps at
once as one [T, L] gather + one einsum (branch-tap contraction, lands on
one matmul) + one batched FFT + a phase twiddle; exactly the Firpfbch2
sliding-transform generalized from M/2 to arbitrary P (firpfbch.py:209).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from .. import design
from ..filter.firpfb import pfb_decompose

__all__ = ["Firpfbchr"]


@struct.pytree
class Firpfbchr:
    """M-channel, P-decimation analysis channelizer (liquid firpfbchr)."""

    num_channels: int = struct.static_field()
    decim: int = struct.static_field()
    branches: jnp.ndarray = struct.field()  # [M, p], branches[b,q] = h[b+qM]
    scale: jnp.ndarray = struct.field()
    hist: jnp.ndarray = struct.field()      # [..., L-1] raw history
    sample_count: jnp.ndarray = struct.field()  # int32, consumed mod M

    @classmethod
    def create(cls, num_channels: int, decim: int, h,
               batch_shape: tuple = ()) -> "Firpfbchr":
        if num_channels < 2:
            raise ConfigError(
                f"number of channels ({num_channels}) must be >= 2")
        if decim < 1:
            raise ConfigError(f"decimation factor ({decim}) must be >= 1")
        if decim > num_channels:
            raise ConfigError(
                f"decimation factor ({decim}) cannot exceed the number of "
                f"channels ({num_channels})")
        M = num_channels
        branches = pfb_decompose(np.asarray(h, dtype=np.float64), M)
        L = branches.shape[1] * M
        return cls(
            num_channels=M, decim=decim,
            branches=jnp.asarray(branches.astype(np.float32)),
            scale=jnp.asarray(1.0, dtype=jnp.float32),
            hist=jnp.zeros(batch_shape + (L - 1,), dtype=jnp.complex64),
            sample_count=jnp.asarray(0, dtype=jnp.int32),
        )

    @classmethod
    def create_kaiser(cls, num_channels: int, decim: int, m: int = 4,
                      as_: float = 60.0, **kw) -> "Firpfbchr":
        """Kaiser prototype at fc = 0.5/M (liquid firpfbchr kaiser ctor)."""
        if m < 1:
            raise ConfigError(f"filter semi-length ({m}) must be >= 1")
        h_len = 2 * num_channels * m + 1
        h = design.fir_design_kaiser(h_len, 0.5 / num_channels, as_, 0.0)
        return cls.create(num_channels, decim, h[: h_len - 1], **kw)

    @property
    def p(self) -> int:
        return self.branches.shape[1]

    def get_delay(self) -> float:
        """Group delay at the channel rate: (L/2) input samples / P."""
        return (self.p * self.num_channels / 2) / self.decim

    def reset(self) -> "Firpfbchr":
        return self.replace(hist=jnp.zeros_like(self.hist),
                            sample_count=jnp.zeros_like(self.sample_count))

    def set_scale(self, scale) -> "Firpfbchr":
        return self.replace(scale=jnp.asarray(scale, dtype=jnp.float32))

    def analyzer_execute(self, x) -> tuple[jnp.ndarray, "Firpfbchr"]:
        """x [..., T·P] → channels [..., M, T].

        Channel k is the input mixed down by k/M, filtered by the
        prototype, and decimated by P; computed for all T steps and all M
        channels in one batch.
        """
        x = jnp.asarray(x, dtype=jnp.complex64)
        M, P = self.num_channels, self.decim
        total = x.shape[-1]
        if total % P:
            raise ConfigError(f"input length must be a multiple of P={P}")
        T = total // P
        L = self.p * M

        xa = jnp.concatenate([self.hist, x], axis=-1)  # [..., L-1+T·P]
        t_idx = jnp.arange(T)

        # y_k[t] = e^{-j2πk e_t/M} Σ_j h[j]·frame[t,j]·e^{+j2πkj/M}
        # grouped by residue r = j mod M → M-point inverse DFT of
        # c_r[t] = Σ_q h[r+qM]·frame[t, r+qM], computed gather-free as one
        # strided residue conv (firpfbch._sliding_residue_conv)
        from .firpfbch import _sliding_residue_conv

        c = _sliding_residue_conv(xa, self.branches, P)  # [..., T, M]
        Y = jnp.fft.ifft(c, axis=-1) * M
        # reduce mod M before the complex exponential: the twiddle is
        # M-periodic, and small arguments keep float32 phase exact
        e_glob = jnp.mod((t_idx + 1) * P - 1 + self.sample_count, M)
        twiddle = jnp.exp(
            -2j * np.pi * jnp.arange(M)[None, :] * e_glob[:, None] / M
        ).astype(jnp.complex64)
        y = (Y * twiddle) * self.scale
        y = jnp.swapaxes(y, -1, -2)  # [..., M, T]

        new = self.replace(
            hist=xa[..., xa.shape[-1] - (L - 1):],
            sample_count=jnp.mod(self.sample_count + T * P, M),
        )
        return y, new
