"""Transforms (reference layer L2).

Behavioral spec: /root/reference/src/fft/mod.rs. Conventions (fft/mod.rs:125-150
test runner): forward transform is unnormalized (e^{-j2πkn/N} kernel), the
inverse is unnormalized too — callers divide by N. This matches jnp.fft.fft /
jnp.fft.ifft·N, which XLA lowers to the device's FFT library.

Unlike the reference (which delegates to the third-party rustfft), this
build leans on XLA's FFT; arbitrary sizes (radix-2, composite, prime) are all
supported and validated against the reference's golden vectors.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..errors import ConfigError
from .spgram import Spgram, spgram_estimate_psd  # noqa: F401
from .spwaterfall import Spwaterfall  # noqa: F401
from .r2r import dct, dst, r2r_inverse_scale  # noqa: F401
from .asgram import Asgram  # noqa: F401

__all__ = [
    "FFT_FORWARD",
    "FFT_BACKWARD",
    "fft_run",
    "ifft_run",
    "fft_shift",
    "Fft",
    "Spgram",
    "spgram_estimate_psd",
    "Spwaterfall",
]

FFT_FORWARD = "forward"
FFT_BACKWARD = "backward"


def fft_run(x, direction: str = FFT_FORWARD):
    """One-shot transform with liquid conventions (fft/mod.rs:66).

    Forward: X[k] = Σ x[n] e^{-j2πkn/N}.  Backward: unnormalized inverse
    (N · jnp.fft.ifft); the caller divides by N as in the reference tests
    (fft/mod.rs:139-142).
    """
    x = jnp.asarray(x)
    if direction == FFT_FORWARD:
        return jnp.fft.fft(x)
    if direction == FFT_BACKWARD:
        return jnp.fft.ifft(x) * x.shape[-1]
    raise ConfigError(f"unknown FFT direction {direction!r}")


def ifft_run(x):
    """Unnormalized inverse transform (liquid backward convention)."""
    return fft_run(x, FFT_BACKWARD)


def fft_shift(x):
    """liquid's fftshift (fft/mod.rs:50-57).

    For even N identical to jnp.fft.fftshift. For odd N liquid swaps the two
    (N-1)/2 halves and leaves the LAST element in place — subtly different
    from numpy's fftshift; preserved exactly for parity.
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    if n % 2 == 0:
        return jnp.fft.fftshift(x, axes=-1)
    n2 = (n - 1) // 2
    head = x[..., :n2]
    mid = x[..., n2 : 2 * n2]
    tail = x[..., 2 * n2 :]
    return jnp.concatenate([mid, head, tail], axis=-1)


class Fft:
    """Planned-transform object for API parity (fft/mod.rs:34-58).

    XLA handles planning/caching internally, so this is a thin callable.
    """

    def __init__(self, n: int, direction: str = FFT_FORWARD):
        if n < 1:
            raise ConfigError("fft size must be at least 1")
        if direction not in (FFT_FORWARD, FFT_BACKWARD):
            raise ConfigError(f"unknown FFT direction {direction!r}")
        self.n = n
        self.direction = direction

    def run(self, x):
        x = jnp.asarray(x)
        if x.shape[-1] != self.n:
            raise ConfigError(
                f"fft input length {x.shape[-1]} != planned size {self.n}"
            )
        return fft_run(x, self.direction)

    def shift(self, x):
        return fft_shift(x)

    def __repr__(self) -> str:
        return f"Fft(n={self.n}, direction={self.direction})"
