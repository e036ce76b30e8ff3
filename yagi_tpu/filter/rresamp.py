"""Rational P/Q polyphase resampler.

Behavioral spec: /root/reference/src/filter/resampler/rresamp.rs. For every Q
input samples the bank emits exactly P outputs through branches
(j·Q) mod P (rresamp.rs:144-185) — a STATIC emission schedule, making this
the fully jit-static resampler (SURVEY.md §7 recommends it where the
arbitrary resampler's data-dependent counts are inconvenient).

Vectorized form: output o in a block maps to source input
i_o = (o//P)·Q + floor((o mod P)·Q/P) and branch ((o mod P)·Q) mod P —
precomputed host-side; the block execute is one frame-gather + contraction.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from .. import design
from .firpfb import pfb_decompose

__all__ = ["Rresamp"]


@struct.pytree
class Rresamp:
    """Rational resampler state (rresamp.rs:8-15)."""

    p: int = struct.static_field()  # interpolation (numerator), gcd-reduced
    q: int = struct.static_field()  # decimation (denominator), gcd-reduced
    m: int = struct.static_field()  # filter semi-length
    block_len: int = struct.static_field()  # gcd
    branches: jnp.ndarray = struct.field()  # [P, 2m] conv order
    scale: jnp.ndarray = struct.field()
    window: jnp.ndarray = struct.field()  # [..., 2m]

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, interp: int, decim: int, m: int, h, batch_shape: tuple = (), dtype=jnp.complex64) -> "Rresamp":
        """From prototype h of length 2·interp·m (rresamp.rs:23-46)."""
        if interp == 0:
            raise ConfigError("interpolation rate must be greater than zero")
        if decim == 0:
            raise ConfigError("decimation rate must be greater than zero")
        if m == 0:
            raise ConfigError("filter semi-length must be greater than zero")
        h = np.asarray(h)
        branches = pfb_decompose(h[: 2 * interp * m], interp)
        return cls(
            p=interp,
            q=decim,
            m=m,
            block_len=1,
            branches=jnp.asarray(branches.astype(np.complex64 if np.iscomplexobj(h) else np.float32)),
            scale=jnp.asarray(1.0, dtype=jnp.float32),
            window=jnp.zeros(batch_shape + (branches.shape[1],), dtype=jnp.dtype(dtype)),
        )

    @classmethod
    def create_kaiser(cls, interp: int, decim: int, m: int = 12, bw: float = -1.0, as_: float = 60.0, **kw) -> "Rresamp":
        """Kaiser prototype with liquid's bandwidth/scale rules (rresamp.rs:48-71)."""
        if interp == 0:
            raise ConfigError("interpolation rate must be greater than zero")
        if decim == 0:
            raise ConfigError("decimation rate must be greater than zero")
        g = math.gcd(interp, decim)
        interp_r, decim_r = interp // g, decim // g
        if bw < 0.0:
            bw = 0.5 if interp_r > decim_r else 0.5 * interp_r / decim_r
        elif bw > 0.5:
            raise ConfigError(f"invalid bandwidth ({bw}), must be less than 0.5")
        h_len = 2 * interp_r * m + 1
        hf = design.fir_design_kaiser(h_len, bw / interp_r, as_, 0.0)
        obj = cls.create(interp_r, decim_r, m, hf, **kw)
        obj = obj.set_scale(2.0 * bw * np.sqrt(obj.q / obj.p))
        return obj.replace(block_len=g)

    @classmethod
    def create_prototype(cls, ftype, interp: int, decim: int, m: int, beta: float, **kw) -> "Rresamp":
        """(root-)Nyquist prototype (rresamp.rs:73-92)."""
        if interp == 0:
            raise ConfigError("interpolation rate must be greater than zero")
        if decim == 0:
            raise ConfigError("decimation rate must be greater than zero")
        g = math.gcd(interp, decim)
        interp_r, decim_r = interp // g, decim // g
        decim_flag = interp_r < decim_r
        k = decim_r if decim_flag else interp_r
        hf = design.fir_design_prototype(ftype, k, m, beta, 0.0)
        obj = cls.create(interp_r, decim_r, m, hf, **kw)
        rate = obj.p / obj.q
        obj = obj.set_scale(np.sqrt(rate) if decim_flag else 1.0 / np.sqrt(rate))
        return obj.replace(block_len=g)

    @classmethod
    def create_default(cls, interp: int, decim: int, **kw) -> "Rresamp":
        """m=12, bw=0.5, As=60 (rresamp.rs:95-100)."""
        return cls.create_kaiser(interp, decim, 12, 0.5, 60.0, **kw)

    # ------------------------------------------------------------ properties
    def get_rate(self) -> float:
        return self.p / self.q

    def get_p(self) -> int:
        return self.p * self.block_len

    def get_q(self) -> int:
        return self.q * self.block_len

    def get_interp(self) -> int:
        return self.p

    def get_decim(self) -> int:
        return self.q

    def get_block_len(self) -> int:
        return self.block_len

    def get_delay(self) -> int:
        return self.m

    @property
    def sub_len(self) -> int:
        return self.branches.shape[1]

    def reset(self) -> "Rresamp":
        return self.replace(window=jnp.zeros_like(self.window))

    def set_scale(self, scale) -> "Rresamp":
        return self.replace(scale=jnp.asarray(scale, dtype=jnp.float32))

    def get_scale(self):
        return self.scale

    def write(self, x) -> "Rresamp":
        """Push samples without producing output (rresamp.rs:141)."""
        x = jnp.asarray(x)
        xa = jnp.concatenate([self.window, x.astype(self.window.dtype)], axis=-1)
        return self.replace(window=xa[..., xa.shape[-1] - self.sub_len :])

    # ------------------------------------------------------------- streaming
    def execute_block(self, x) -> tuple[jnp.ndarray, "Rresamp"]:
        """n·Q inputs → n·P outputs (rresamp.rs:144-160).

        Static schedule: output o = blk·P + j fires after consuming input
        blk·Q + floor(j·Q/P), through branch (j·Q) mod P.
        """
        x = jnp.asarray(x)
        n_in = x.shape[-1]
        Q = self.q * 1  # per primitive
        P = self.p
        if n_in % self.q != 0:
            raise ConfigError(
                f"input length {n_in} must be a multiple of decim Q={self.q}"
            )
        n_blk = n_in // self.q
        n_out = n_blk * P
        L = self.sub_len

        xa = jnp.concatenate([self.window[..., 1:].astype(x.dtype), x], axis=-1)
        from ._sched import sched_banded_matmul, sched_matmul_ok

        j = np.arange(P)
        src_off = (j * self.q) // P
        branch = (j * self.q) % P
        if sched_matmul_ok(P, self.q, L):
            # static schedule → banded matmul instead of a frame gather
            y = sched_banded_matmul(xa, self.branches, src_off, branch,
                                    self.q, n_blk)
        else:  # heavy decimation: band matrix would be mostly zeros
            src = np.arange(n_out) // P * self.q + src_off[np.arange(n_out) % P]
            frame_idx = jnp.asarray(src[:, None] + np.arange(L)[None, :])
            frames = xa[..., frame_idx]  # [..., n_out, L]
            hb = jnp.take(self.branches, jnp.asarray(branch[np.arange(n_out) % P]), axis=0)
            y = jnp.einsum(
                "...cl,cl->...c", frames, hb[:, ::-1],
                precision=jax.lax.Precision.HIGHEST,
            )
        y = y * self.scale
        new_window = xa[..., xa.shape[-1] - L :]
        return y, self.replace(window=new_window)

    __call__ = execute_block
