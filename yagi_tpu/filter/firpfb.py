"""Polyphase filter bank.

Behavioral spec: /root/reference/src/filter/fir/firpfb.rs. The prototype
filter h (length M·Lsub) is decomposed so branch i computes
y_i[t] = Σ_j h[i + j·M] · x[t-j] (firpfb.rs:45-52 stores each branch reversed
for its oldest-first window dotprod; we store branches in convolution order).
A shared input window is carried in the state; branch selection is either a
static int (Python) or a traced index (jnp.take over the branch axis).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from .. import design
from ._conv import causal_conv_valid, multi_branch_conv, np_taps, result_dtype

__all__ = ["FirPfbFilter", "pfb_decompose"]


def pfb_decompose(h: np.ndarray, num_filters: int) -> np.ndarray:
    """[M·Lsub] prototype → [M, Lsub] branch matrix, convolution order.

    branches[i, j] = h[i + j·M]; truncates any trailing remainder exactly as
    the reference's h_sub_len = h_len // num_filters (firpfb.rs:42).
    """
    h = np.asarray(h)
    sub_len = len(h) // num_filters
    return np.stack(
        [h[i : i + sub_len * num_filters : num_filters] for i in range(num_filters)]
    )


@struct.pytree
class FirPfbFilter:
    """PFB state (reference struct firpfb.rs:10-15)."""

    branches: jnp.ndarray = struct.field()  # [M, Lsub] convolution order
    scale: jnp.ndarray = struct.field()
    window: jnp.ndarray = struct.field()  # [..., Lsub] oldest..newest

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(
        cls, num_filters: int, h, scale=1.0, batch_shape: tuple = (), dtype=None
    ) -> "FirPfbFilter":
        """From prototype coefficients (firpfb.rs:34)."""
        if num_filters == 0:
            raise ConfigError("number of filters must be greater than zero")
        h = np_taps(h)
        if h.size == 0:
            raise ConfigError("filter length must be greater than zero")
        branches = pfb_decompose(h, num_filters)
        if dtype is None:
            dtype = jnp.complex64 if np.iscomplexobj(h) else jnp.float32
        return cls(
            branches=jnp.asarray(branches),
            scale=jnp.asarray(scale, dtype=branches.dtype),
            window=jnp.zeros(batch_shape + (branches.shape[1],), dtype=jnp.dtype(dtype)),
        )

    @classmethod
    def create_default(cls, num_filters: int, m: int, **kw) -> "FirPfbFilter":
        """Default Kaiser design (firpfb.rs:79)."""
        return cls.create_kaiser(num_filters, m, 0.5, 60.0, **kw)

    @classmethod
    def create_kaiser(
        cls, num_filters: int, m: int, fc: float, as_: float, **kw
    ) -> "FirPfbFilter":
        """Kaiser prototype, h_len = 2·M·m+1 (firpfb.rs:95)."""
        if num_filters == 0:
            raise ConfigError("number of filters must be greater than zero")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if fc <= 0.0 or fc > 0.5:
            raise ConfigError("filter cut-off frequency must be in (0,0.5)")
        if as_ < 0.0:
            raise ConfigError("stop-band attenuation must be non-negative")
        h_len = 2 * num_filters * m + 1
        h = design.fir_design_kaiser(h_len, fc / num_filters, as_, 0.0)
        return cls.create(num_filters, h, **kw)

    @classmethod
    def create_rnyquist(
        cls, ftype, num_filters: int, k: int, m: int, beta: float, **kw
    ) -> "FirPfbFilter":
        """Root-Nyquist prototype oversampled by the bank size (firpfb.rs:121ff)."""
        h = design.fir_design_prototype(ftype, k * num_filters, m, beta, 0.0)
        return cls.create(num_filters, h, **kw)

    @classmethod
    def create_drnyquist(
        cls, ftype, num_filters: int, k: int, m: int, beta: float, **kw
    ) -> "FirPfbFilter":
        """Derivative root-Nyquist bank for timing recovery (firpfb.rs:163-196).

        dh[i] = h[i+1] - h[i-1] (centered difference, circular ends), matching
        the reference's construction for the dMF bank.
        """
        h = design.fir_design_prototype(ftype, k * num_filters, m, beta, 0.0)
        h_len = len(h)
        dh = np.empty_like(h)
        for i in range(h_len):
            im = (i + h_len - 1) % h_len
            ip = (i + 1) % h_len
            dh[i] = h[ip] - h[im]
        return cls.create(num_filters, dh, **kw)

    # ------------------------------------------------------------- properties
    @property
    def num_filters(self) -> int:
        return self.branches.shape[0]

    @property
    def sub_len(self) -> int:
        return self.branches.shape[1]

    # ------------------------------------------------------------- streaming
    def reset(self) -> "FirPfbFilter":
        return self.replace(window=jnp.zeros_like(self.window))

    def push(self, x) -> "FirPfbFilter":
        """Push one sample (firpfb.rs:255)."""
        x = jnp.asarray(x, dtype=self.window.dtype)
        return self.replace(
            window=jnp.concatenate([self.window[..., 1:], x[..., None]], axis=-1)
        )

    def write(self, x) -> "FirPfbFilter":
        """Push a block (firpfb.rs:264)."""
        x = jnp.asarray(x, dtype=self.window.dtype)
        xa = jnp.concatenate([self.window, x], axis=-1)
        return self.replace(window=xa[..., xa.shape[-1] - self.sub_len :])

    def execute(self, i) -> jnp.ndarray:
        """Branch-i output for the current window (firpfb.rs:277)."""
        hb = jnp.take(self.branches, i, axis=0)  # [Lsub] (traced i OK)
        w = self.window.astype(result_dtype(self.window.dtype, hb.dtype))
        return jnp.sum(hb[::-1] * w, axis=-1) * self.scale

    def execute_block(self, i: int, x) -> tuple[jnp.ndarray, "FirPfbFilter"]:
        """Per-sample push+execute with fixed branch (firpfb.rs:295)."""
        x = jnp.asarray(x)
        xa = jnp.concatenate([self.window[..., 1:].astype(x.dtype), x], axis=-1)
        hb = jnp.take(self.branches, i, axis=0)
        y = causal_conv_valid(xa, hb) * self.scale
        return y, self.replace(window=xa[..., xa.shape[-1] - self.sub_len :])

    def execute_all(self, x) -> tuple[jnp.ndarray, "FirPfbFilter"]:
        """Extension: all M branch outputs for a whole block at once.

        Returns ([..., M, N], updated state); this is the building block for
        interpolation and the channelizer (one XLA conv with M out-channels).
        """
        x = jnp.asarray(x)
        xa = jnp.concatenate([self.window[..., 1:].astype(x.dtype), x], axis=-1)
        y = multi_branch_conv(xa, self.branches) * self.scale
        return y, self.replace(window=xa[..., xa.shape[-1] - self.sub_len :])

    def set_scale(self, scale) -> "FirPfbFilter":
        return self.replace(scale=jnp.asarray(scale, dtype=self.branches.dtype))

    def get_scale(self):
        return self.scale
