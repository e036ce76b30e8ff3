"""LMS adaptive equalizer.

Behavioral spec: /root/reference/src/equalization/eqlms.rs. Weight update
normalized by the windowed input energy: w ← w + μ·conj(α)·r / Σ|x|²
(eqlms.rs:170-187); blind constant-modulus update uses d = d̂/|d̂|
(eqlms.rs:189-192); fractionally-spaced operation trains every k-th sample
(eqlms.rs:153-168). The training loop is a lax.scan (sequential per stream,
batched over channels).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from .. import design

__all__ = ["Eqlms"]


@struct.pytree
class Eqlms:
    """LMS equalizer state (eqlms.rs:7-18).

    ``buffer`` holds the last h_len inputs oldest..newest; execute =
    Σ conj(w[i])·buffer[i] (eqlms.rs:137-140).
    """

    h_len: int = struct.static_field()
    mu: jnp.ndarray = struct.field()
    h0: jnp.ndarray = struct.field()  # [h_len] initial weights
    w: jnp.ndarray = struct.field()  # [..., h_len] current weights
    buffer: jnp.ndarray = struct.field()  # [..., h_len]
    x2: jnp.ndarray = struct.field()  # [..., h_len] |x|² window
    x2_sum: jnp.ndarray = struct.field()
    count: jnp.ndarray = struct.field()  # int32 samples pushed

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, h=None, h_len: int | None = None, batch_shape: tuple = (), dtype=jnp.complex64):
        """From initial taps h (conjugate-reversed internally, eqlms.rs:39-45)
        or identity if None."""
        if h is not None:
            h = np.asarray(h)
            h_len = len(h)
            h0 = np.conj(h[::-1]).astype(np.complex64)
        else:
            if h_len is None:
                raise ConfigError("either h or h_len must be given")
            h0 = np.zeros(h_len, dtype=np.complex64)
            h0[h_len // 2] = 1.0
        return cls(
            h_len=h_len,
            mu=jnp.asarray(0.5, dtype=jnp.float32),
            h0=jnp.asarray(h0),
            w=jnp.broadcast_to(jnp.asarray(h0), batch_shape + (h_len,)),
            buffer=jnp.zeros(batch_shape + (h_len,), dtype=jnp.dtype(dtype)),
            x2=jnp.zeros(batch_shape + (h_len,), dtype=jnp.float32),
            x2_sum=jnp.zeros(batch_shape, dtype=jnp.float32),
            count=jnp.zeros(batch_shape, dtype=jnp.int32),
        )

    @classmethod
    def create_rnyquist(cls, ftype, k: int, m: int, beta: float, dt: float = 0.0, **kw):
        """Square-root Nyquist matched-filter initialization (eqlms.rs:51)."""
        if k < 2:
            raise ConfigError("samples/symbol must be greater than 1")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if not 0.0 <= beta <= 1.0:
            raise ConfigError("filter excess bandwidth factor must be in [0,1]")
        if not -1.0 <= dt <= 1.0:
            raise ConfigError("filter fractional sample delay must be in [-1,1]")
        h = design.fir_design_prototype(ftype, k, m, beta, dt) / k
        return cls.create(h=h, **kw)

    @classmethod
    def create_lowpass(cls, h_len: int, fc: float, **kw):
        """Lowpass initialization (eqlms.rs:78)."""
        if h_len == 0:
            raise ConfigError("filter length must be greater than 0")
        if not 0.0 < fc <= 0.5:
            raise ConfigError("filter cutoff must be in (0,0.5]")
        h = design.fir_design_kaiser(h_len, fc, 40.0, 0.0) * 2.0 * fc
        return cls.create(h=h, **kw)

    # ---------------------------------------------------------------- control
    def reset(self) -> "Eqlms":
        return self.replace(
            w=jnp.broadcast_to(self.h0, self.w.shape),
            buffer=jnp.zeros_like(self.buffer),
            x2=jnp.zeros_like(self.x2),
            x2_sum=jnp.zeros_like(self.x2_sum),
            count=jnp.zeros_like(self.count),
        )

    def set_bw(self, mu) -> "Eqlms":
        if isinstance(mu, (int, float)) and mu < 0.0:
            raise ConfigError("learning rate cannot be less than zero")
        return self.replace(mu=jnp.asarray(mu, dtype=jnp.float32))

    def get_bw(self):
        return self.mu

    def get_weights(self):
        """User-facing taps = conj-reversed internal weights (eqlms.rs:121)."""
        return jnp.conj(self.w[..., ::-1])

    # ------------------------------------------------------------- primitives
    def push(self, x) -> "Eqlms":
        """Push one sample (eqlms.rs:125)."""
        x = jnp.asarray(x, dtype=self.buffer.dtype)
        x2n = jnp.abs(x) ** 2
        x2_0 = self.x2[..., 0]
        return self.replace(
            buffer=jnp.concatenate([self.buffer[..., 1:], x[..., None]], axis=-1),
            x2=jnp.concatenate([self.x2[..., 1:], x2n[..., None]], axis=-1),
            x2_sum=self.x2_sum + x2n - x2_0,
            count=self.count + 1,
        )

    def execute(self):
        """Current output Σ conj(w)·buffer (eqlms.rs:137)."""
        return jnp.sum(jnp.conj(self.w) * self.buffer, axis=-1)

    def step(self, d, d_hat) -> "Eqlms":
        """Training update (eqlms.rs:170-187); inactive until buffer fills."""
        alpha = jnp.asarray(d) - jnp.asarray(d_hat)
        upd = self.w + (self.mu * jnp.conj(alpha)[..., None] * self.buffer) / jnp.maximum(
            self.x2_sum[..., None], 1e-20
        )
        ready = (self.count >= self.h_len)[..., None]
        return self.replace(w=jnp.where(ready, upd, self.w))

    def step_blind(self, d_hat) -> "Eqlms":
        """Constant-modulus blind update (eqlms.rs:189)."""
        d = d_hat / jnp.maximum(jnp.abs(d_hat), 1e-20)
        return self.step(d, d_hat)

    # --------------------------------------------------------------- training
    def train_block(self, x, d) -> tuple[jnp.ndarray, "Eqlms"]:
        """Supervised training over (x, d) pairs via scan.

        Per sample: push, y = execute, update toward d. Returns outputs.
        Scan boundaries are planar f32 (``utils.planar.planar_scan`` rules).
        """
        from ..utils.planar import planarize, unplanarize

        x = jnp.asarray(x, self.buffer.dtype)
        d = jnp.asarray(d, self.buffer.dtype)
        xs = (
            jnp.moveaxis(jnp.real(x), -1, 0), jnp.moveaxis(jnp.imag(x), -1, 0),
            jnp.moveaxis(jnp.real(d), -1, 0), jnp.moveaxis(jnp.imag(d), -1, 0),
        )

        def body(eq_p, inp):
            xr, xi, dr, di = inp
            eq = unplanarize(eq_p)
            eq = eq.push(jax.lax.complex(xr, xi))
            y = eq.execute()
            eq = eq.step(jax.lax.complex(dr, di), y)
            return planarize(eq), jnp.stack([jnp.real(y), jnp.imag(y)], -1)

        eq_p, packed = jax.lax.scan(body, planarize(self), xs, unroll=4)
        packed = jnp.moveaxis(packed, 0, -2)
        return jax.lax.complex(packed[..., 0], packed[..., 1]), unplanarize(eq_p)

    def execute_block(self, k: int, x) -> tuple[jnp.ndarray, "Eqlms"]:
        """Blind decision-directed processing (eqlms.rs:153-168): output every
        sample, CM-update every k-th."""
        from ..utils.planar import planarize, unplanarize

        if k == 0:
            raise ConfigError("down-sampling rate 'k' must be greater than 0")
        x = jnp.asarray(x, self.buffer.dtype)
        xs = (jnp.moveaxis(jnp.real(x), -1, 0), jnp.moveaxis(jnp.imag(x), -1, 0))

        def body(eq_p, inp):
            xr, xi = inp
            eq = unplanarize(eq_p)
            eq = eq.push(jax.lax.complex(xr, xi))
            y = eq.execute()
            do_update = ((eq.count + k - 1) % k) == 0
            eq_upd = eq.step_blind(y)
            eq = jax.tree_util.tree_map(
                lambda a, b: jnp.where(
                    do_update.reshape(do_update.shape + (1,) * (a.ndim - do_update.ndim))
                    if a.ndim > do_update.ndim
                    else do_update,
                    b,
                    a,
                ),
                eq,
                eq_upd,
            )
            return planarize(eq), jnp.stack([jnp.real(y), jnp.imag(y)], -1)

        eq_p, packed = jax.lax.scan(body, planarize(self), xs, unroll=4)
        packed = jnp.moveaxis(packed, 0, -2)
        return jax.lax.complex(packed[..., 0], packed[..., 1]), unplanarize(eq_p)

    def decim_execute(self, x, k: int):
        """Push k samples, output at the first (eqlms.rs:142-151)."""
        x = jnp.asarray(x)
        eq = self.push(x[..., 0])
        y = eq.execute()
        for i in range(1, k):
            eq = eq.push(x[..., i])
        return y, eq
