"""Real-to-real transforms: DCT-I..IV and DST-I..IV.

The reference never ported liquid's ``fft_r2r_*`` (SURVEY.md §2.2 "NOT
ported": LIQUID_COMPAT.md:419-446 all ❓); behavioral spec is liquid-dsp /
FFTW's eight REDFT/RODFT kinds with FFTW's unnormalized conventions
(forward·inverse = logical-size identity scale).

Block-parallel: each kind is one basis matmul ``y = B @ x`` batched over leading
dims — a matmul formulation that is exact for any N (including the
odd/prime sizes liquid's autotests use) and fuses with neighboring ops
under jit. The basis is built host-side once per (kind, N) and cached.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..errors import ConfigError

__all__ = ["dct", "dst", "r2r_inverse_scale"]


@lru_cache(maxsize=None)
def _dct_basis(kind: int, n: int) -> np.ndarray:
    j = np.arange(n, dtype=np.float64)[None, :]
    k = np.arange(n, dtype=np.float64)[:, None]
    if kind == 1:   # REDFT00, N >= 2
        if n < 2:
            raise ConfigError(f"DCT-I size ({n}) must be >= 2")
        B = 2.0 * np.cos(np.pi * j * k / (n - 1))
        B[:, 0] = 1.0
        B[:, -1] = (-1.0) ** np.arange(n)
        return B
    if kind == 2:   # REDFT10
        return 2.0 * np.cos(np.pi * (j + 0.5) * k / n)
    if kind == 3:   # REDFT01
        B = 2.0 * np.cos(np.pi * j * (k + 0.5) / n)
        B[:, 0] = 1.0
        return B
    if kind == 4:   # REDFT11
        return 2.0 * np.cos(np.pi * (j + 0.5) * (k + 0.5) / n)
    raise ConfigError(f"DCT kind ({kind}) must be in 1..4")


@lru_cache(maxsize=None)
def _dst_basis(kind: int, n: int) -> np.ndarray:
    j = np.arange(n, dtype=np.float64)[None, :]
    k = np.arange(n, dtype=np.float64)[:, None]
    if kind == 1:   # RODFT00
        return 2.0 * np.sin(np.pi * (j + 1.0) * (k + 1.0) / (n + 1))
    if kind == 2:   # RODFT10
        return 2.0 * np.sin(np.pi * (j + 0.5) * (k + 1.0) / n)
    if kind == 3:   # RODFT01
        B = 2.0 * np.sin(np.pi * (j + 1.0) * (k + 0.5) / n)
        B[:, -1] = (-1.0) ** np.arange(n)
        return B
    if kind == 4:   # RODFT11
        return 2.0 * np.sin(np.pi * (j + 0.5) * (k + 0.5) / n)
    raise ConfigError(f"DST kind ({kind}) must be in 1..4")


def dct(x, kind: int = 2):
    """DCT of ``x`` along the last axis (FFTW REDFT conventions)."""
    x = jnp.asarray(x)
    B = jnp.asarray(_dct_basis(kind, x.shape[-1]), dtype=jnp.float32)
    return jnp.einsum("kj,...j->...k", B, x.astype(jnp.float32))


def dst(x, kind: int = 1):
    """DST of ``x`` along the last axis (FFTW RODFT conventions)."""
    x = jnp.asarray(x)
    B = jnp.asarray(_dst_basis(kind, x.shape[-1]), dtype=jnp.float32)
    return jnp.einsum("kj,...j->...k", B, x.astype(jnp.float32))


def r2r_inverse_scale(kind: str, n: int) -> float:
    """FFTW logical-size normalization: applying the forward/inverse pair
    multiplies the data by this factor."""
    return {
        "dct1": 2.0 * (n - 1), "dct2": 2.0 * n, "dct3": 2.0 * n,
        "dct4": 2.0 * n,
        "dst1": 2.0 * (n + 1), "dst2": 2.0 * n, "dst3": 2.0 * n,
        "dst4": 2.0 * n,
    }[kind]
