"""Overlap-add frequency-domain FIR filter.

Behavioral spec: /root/reference/src/filter/fftfilt.rs. Fixed block size n,
2n-point FFT, Y = X·H, IFFT, add saved tail, save new tail
(fftfilt.rs:103-138). This is the natural block filter — the whole
execute is three fused XLA ops; multiple blocks batch into ONE batched FFT.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from ._conv import np_taps

__all__ = ["FftFilt"]


@struct.pytree
class FftFilt:
    """Overlap-add state (fftfilt.rs:22-38)."""

    n: int = struct.static_field()  # block size
    h_len: int = struct.static_field()
    real_io: bool = struct.static_field()  # rrrf variant returns real part
    h_freq: jnp.ndarray = struct.field()  # [2n] filter spectrum
    scale: jnp.ndarray = struct.field()  # includes 1/(2n) ifft normalization
    w: jnp.ndarray = struct.field()  # [..., n] saved overlap tail

    @classmethod
    def create(cls, h, n: int, batch_shape: tuple = (), dtype=None) -> "FftFilt":
        """Precompute H = FFT(h, 2n) (fftfilt.rs:46-83)."""
        h = np_taps(h)
        h_len = len(h)
        if h_len == 0:
            raise ConfigError("filter length must be greater than zero")
        if n < h_len - 1:
            raise ConfigError(f"block length must be greater than h_len-1 ({h_len - 1})")
        if dtype is None:
            dtype = jnp.complex64 if np.iscomplexobj(h) else jnp.float32
        real_io = not jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating)
        h_freq = np.fft.fft(h.astype(np.complex64), 2 * n)
        return cls(
            n=n,
            h_len=h_len,
            real_io=real_io,
            h_freq=jnp.asarray(h_freq.astype(np.complex64)),
            scale=jnp.asarray(1.0 / (2.0 * n), dtype=jnp.float32),
            w=jnp.zeros(batch_shape + (n,), dtype=jnp.complex64),
        )

    def reset(self) -> "FftFilt":
        return self.replace(w=jnp.zeros_like(self.w))

    def set_scale(self, scale) -> "FftFilt":
        """Stored scale folds in the 1/(2n) inverse normalization (fftfilt.rs:95)."""
        return self.replace(
            scale=jnp.asarray(scale, dtype=jnp.float32) / (2.0 * self.n)
        )

    def get_scale(self):
        return self.scale * (2.0 * self.n)

    def execute(self, x) -> tuple[jnp.ndarray, "FftFilt"]:
        """Filter one n-sample block (fftfilt.rs:103-138)."""
        x = jnp.asarray(x)
        if x.shape[-1] != self.n:
            raise ConfigError("input length must match filter block size")
        xt = jnp.concatenate(
            [x.astype(jnp.complex64), jnp.zeros(x.shape[:-1] + (self.n,), jnp.complex64)],
            axis=-1,
        )
        X = jnp.fft.fft(xt, axis=-1)
        # liquid backward convention is unnormalized; scale carries 1/(2n)
        yt = jnp.fft.ifft(X * self.h_freq, axis=-1) * (2 * self.n)
        y = (yt[..., : self.n] + self.w) * self.scale
        new_w = yt[..., self.n :]
        if self.real_io:
            y = y.real
        return y, self.replace(w=new_w)

    __call__ = execute

    def execute_blocks(self, x) -> tuple[jnp.ndarray, "FftFilt"]:
        """Filter x of length k·n: all k FFTs batched, overlap-add chained.

        The inter-block dependency is only the additive tail; computed with
        one batched FFT + a shifted add (no scan needed).
        """
        x = jnp.asarray(x)
        total = x.shape[-1]
        if total % self.n != 0:
            raise ConfigError("input length must be a multiple of the block size")
        k = total // self.n
        xb = x.reshape(x.shape[:-1] + (k, self.n)).astype(jnp.complex64)
        xt = jnp.concatenate([xb, jnp.zeros_like(xb)], axis=-1)
        Y = jnp.fft.ifft(jnp.fft.fft(xt, axis=-1) * self.h_freq, axis=-1) * (
            2 * self.n
        )
        heads = Y[..., : self.n]  # [..., k, n]
        tails = Y[..., self.n :]
        prev_tails = jnp.concatenate(
            [self.w[..., None, :], tails[..., :-1, :]], axis=-2
        )
        y = (heads + prev_tails) * self.scale
        y = y.reshape(x.shape[:-1] + (total,))
        if self.real_io:
            y = y.real
        return y, self.replace(w=tails[..., -1, :])

    def get_length(self) -> int:
        return self.h_len
