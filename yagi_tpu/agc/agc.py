"""Automatic gain control.

Behavioral spec: /root/reference/src/agc/agc.rs. Per sample (agc.rs:71-89):
  y = g·x;  y2' = (1-α)·y2' + α·|y|²;  g *= exp(-½·α·ln y2')  (unlocked)
with a 7-state squelch FSM (agc.rs:212-248). The loop is a feedback
recurrence → lax.scan over time; channels batch through the scan body
(SURVEY.md §7: "loops are lax.scan over time, vmapped over channels").
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError

__all__ = ["Agc", "AgcSquelchMode"]

_AGC_DEFAULT_BW = 1e-2


class AgcSquelchMode(enum.IntEnum):
    """Squelch FSM states (agc.rs:22-31)."""

    DISABLED = 0
    ENABLED = 1
    RISE = 2
    SIGNAL_HI = 3
    FALL = 4
    SIGNAL_LO = 5
    TIMEOUT = 6


def _squelch_step(mode, timer, threshold_exceeded, timeout):
    """One squelch FSM transition (agc.rs:212-248); all traced int32."""
    te = threshold_exceeded

    def from_enabled():
        return jnp.where(te, AgcSquelchMode.RISE, AgcSquelchMode.ENABLED), timer

    def from_rise_or_hi():
        return jnp.where(te, AgcSquelchMode.SIGNAL_HI, AgcSquelchMode.FALL), timer

    def from_fall():
        return (
            jnp.where(te, AgcSquelchMode.SIGNAL_HI, AgcSquelchMode.SIGNAL_LO),
            jnp.asarray(timeout, timer.dtype),
        )

    def from_lo():
        t = timer - 1
        new_mode = jnp.where(
            t == 0,
            AgcSquelchMode.TIMEOUT,
            jnp.where(te, AgcSquelchMode.SIGNAL_HI, AgcSquelchMode.SIGNAL_LO),
        )
        return new_mode, t

    modes = jnp.asarray(mode, jnp.int32)
    new_mode = jnp.select(
        [
            modes == AgcSquelchMode.ENABLED,
            (modes == AgcSquelchMode.RISE) | (modes == AgcSquelchMode.SIGNAL_HI),
            modes == AgcSquelchMode.FALL,
            modes == AgcSquelchMode.SIGNAL_LO,
            modes == AgcSquelchMode.TIMEOUT,
        ],
        [
            from_enabled()[0],
            from_rise_or_hi()[0],
            from_fall()[0],
            from_lo()[0],
            jnp.asarray(AgcSquelchMode.ENABLED, jnp.int32),
        ],
        default=jnp.asarray(AgcSquelchMode.DISABLED, jnp.int32),
    ).astype(jnp.int32)
    new_timer = jnp.select(
        [modes == AgcSquelchMode.FALL, modes == AgcSquelchMode.SIGNAL_LO],
        [jnp.asarray(timeout, timer.dtype), timer - 1],
        default=timer,
    )
    return new_mode, new_timer


@struct.pytree
class Agc:
    """AGC state (agc.rs:8-20)."""

    squelch_timeout: int = struct.static_field()
    g: jnp.ndarray = struct.field()  # gain
    scale: jnp.ndarray = struct.field()
    alpha: jnp.ndarray = struct.field()  # loop bandwidth
    y2_prime: jnp.ndarray = struct.field()  # filtered output energy
    locked: jnp.ndarray = struct.field()  # bool
    squelch_mode: jnp.ndarray = struct.field()  # int32 FSM state
    squelch_threshold: jnp.ndarray = struct.field()
    squelch_timer: jnp.ndarray = struct.field()

    @classmethod
    def create(cls, bandwidth: float = _AGC_DEFAULT_BW, batch_shape: tuple = ()) -> "Agc":
        if not (0.0 <= bandwidth <= 1.0):
            raise ConfigError("bandwidth must be in [0, 1]")
        f32 = lambda v: jnp.full(batch_shape, v, dtype=jnp.float32)  # noqa: E731
        return cls(
            squelch_timeout=100,
            g=f32(1.0),
            scale=f32(1.0),
            alpha=f32(bandwidth),
            y2_prime=f32(1.0),
            locked=jnp.full(batch_shape, False),
            squelch_mode=jnp.full(batch_shape, AgcSquelchMode.DISABLED, dtype=jnp.int32),
            squelch_threshold=f32(0.0),
            squelch_timer=jnp.full(batch_shape, 100, dtype=jnp.int32),
        )

    # ---------------------------------------------------------------- control
    def reset(self) -> "Agc":
        """Reset gain/energy; squelch back to Enabled unless disabled (agc.rs:60)."""
        return self.replace(
            g=jnp.ones_like(self.g),
            y2_prime=jnp.ones_like(self.y2_prime),
            locked=jnp.zeros_like(self.locked),
            squelch_mode=jnp.where(
                self.squelch_mode == AgcSquelchMode.DISABLED,
                AgcSquelchMode.DISABLED,
                AgcSquelchMode.ENABLED,
            ).astype(jnp.int32),
        )

    def lock(self) -> "Agc":
        return self.replace(locked=jnp.ones_like(self.locked))

    def unlock(self) -> "Agc":
        return self.replace(locked=jnp.zeros_like(self.locked))

    def set_bandwidth(self, bt: float) -> "Agc":
        if isinstance(bt, (int, float)) and not (0.0 <= bt <= 1.0):
            raise ConfigError("bandwidth must be in [0, 1]")
        return self.replace(alpha=jnp.broadcast_to(jnp.asarray(bt, jnp.float32), self.alpha.shape))

    def get_bandwidth(self):
        return self.alpha

    def get_signal_level(self):
        return 1.0 / self.g

    def set_signal_level(self, x2) -> "Agc":
        if isinstance(x2, (int, float)) and x2 <= 0.0:
            raise ConfigError("signal level must be greater than zero")
        return self.replace(
            g=jnp.broadcast_to(1.0 / jnp.asarray(x2, jnp.float32), self.g.shape),
            y2_prime=jnp.ones_like(self.y2_prime),
        )

    def get_rssi(self):
        """RSSI estimate = -20·log10(g) (agc.rs:136)."""
        return -20.0 * jnp.log10(self.g)

    def set_rssi(self, rssi) -> "Agc":
        g = jnp.maximum(10.0 ** (-jnp.asarray(rssi, jnp.float32) / 20.0), 1e-16)
        return self.replace(
            g=jnp.broadcast_to(g, self.g.shape), y2_prime=jnp.ones_like(self.y2_prime)
        )

    def get_gain(self):
        return self.g

    def set_gain(self, gain) -> "Agc":
        if isinstance(gain, (int, float)) and gain <= 0.0:
            raise ConfigError("gain must be greater than zero")
        return self.replace(g=jnp.broadcast_to(jnp.asarray(gain, jnp.float32), self.g.shape))

    def set_scale(self, scale) -> "Agc":
        if isinstance(scale, (int, float)) and scale <= 0.0:
            raise ConfigError("scale must be greater than zero")
        return self.replace(scale=jnp.broadcast_to(jnp.asarray(scale, jnp.float32), self.scale.shape))

    def get_scale(self):
        return self.scale

    def init(self, x) -> "Agc":
        """Estimate signal level from a block (agc.rs:171-178)."""
        x = jnp.asarray(x)
        if x.shape[-1] == 0:
            raise ConfigError("number of samples must be greater than zero")
        x2 = jnp.sqrt(jnp.mean(jnp.abs(x) ** 2, axis=-1)) + 1e-16
        return self.set_signal_level(x2)

    # ---------------------------------------------------------------- squelch
    def squelch_enable(self) -> "Agc":
        return self.replace(
            squelch_mode=jnp.full_like(self.squelch_mode, AgcSquelchMode.ENABLED)
        )

    def squelch_disable(self) -> "Agc":
        return self.replace(
            squelch_mode=jnp.full_like(self.squelch_mode, AgcSquelchMode.DISABLED)
        )

    def squelch_set_threshold(self, threshold) -> "Agc":
        return self.replace(
            squelch_threshold=jnp.broadcast_to(
                jnp.asarray(threshold, jnp.float32), self.squelch_threshold.shape
            )
        )

    def squelch_get_threshold(self):
        return self.squelch_threshold

    def squelch_set_timeout(self, timeout: int) -> "Agc":
        """Hysteresis timeout in samples (agc.rs:200-202).

        Only stores the timeout; a countdown already in progress
        (SQUELCH_TIMEOUT state) keeps its current timer, matching the
        reference.
        """
        if timeout <= 0:
            raise ConfigError("squelch timeout must be greater than zero")
        return self.replace(squelch_timeout=int(timeout))

    def squelch_get_timeout(self) -> int:
        return self.squelch_timeout

    def squelch_is_enabled(self):
        return self.squelch_mode != AgcSquelchMode.DISABLED

    def squelch_get_status(self):
        return self.squelch_mode

    # ------------------------------------------------------------- streaming
    def execute_block(self, x, samples_per_step: int | None = None
                      ) -> tuple[jnp.ndarray, "Agc"]:
        """Gain-control a block via time scan (agc.rs:91).

        Scan boundaries are planar f32 (xs split re/im, ys one packed f32
        array), the boundary rules of :func:`yagi_tpu.utils.planar.planar_scan`.
        ``samples_per_step`` packs S samples into each scan step (default 1;
        S must divide the block length) to amortize the while-loop's fixed
        cost per step. Results are bit-identical for any S (samples
        are applied sequentially within a step).
        """
        x = jnp.asarray(x)
        n = x.shape[-1]
        is_c = jnp.issubdtype(x.dtype, jnp.complexfloating)
        S = 1 if samples_per_step is None else samples_per_step
        if n % S != 0:
            raise ConfigError("samples_per_step must divide the block length")
        xt_r = jnp.moveaxis(jnp.real(x), -1, 0)
        xt_i = jnp.moveaxis(jnp.imag(x), -1, 0) if is_c else jnp.zeros_like(xt_r)
        # [n, ...] → [n/S, S, ...]
        xt_r = xt_r.reshape((n // S, S) + xt_r.shape[1:])
        xt_i = xt_i.reshape((n // S, S) + xt_i.shape[1:])
        timeout = self.squelch_timeout

        def sample(carry, xr, xi):
            g, y2p, mode, timer = carry
            yr = xr * g
            yi = xi * g
            y2 = yr * yr + yi * yi
            y2p_new = (1.0 - self.alpha) * y2p + self.alpha * y2
            g_upd = g * jnp.exp(-0.5 * self.alpha * jnp.log(jnp.maximum(y2p_new, 1e-30)))
            g_upd = jnp.where(y2p_new > 1e-6, g_upd, g)
            g_upd = jnp.minimum(g_upd, 1e6)
            g_new = jnp.where(self.locked, g, g_upd)
            rssi = -20.0 * jnp.log10(g_new)
            te = rssi > self.squelch_threshold
            mode_new, timer_new = _squelch_step(mode, timer, te, timeout)
            mode_new = jnp.where(self.locked, mode, mode_new)
            timer_new = jnp.where(self.locked, timer, timer_new)
            s = jnp.where(self.locked, 1.0, self.scale)
            return (g_new, y2p_new, mode_new, timer_new), (yr * s, yi * s)

        def step(carry, inp):
            xr, xi = inp
            outs = []
            for s in range(S):
                carry, (yr, yi) = sample(carry, xr[s], xi[s])
                outs.append(jnp.stack([yr, yi], axis=-1))
            return carry, (jnp.stack(outs, axis=-2) if S > 1 else outs[0])

        carry0 = (self.g, self.y2_prime, self.squelch_mode, self.squelch_timer)
        (g, y2p, mode, timer), packed = jax.lax.scan(
            step, carry0, (xt_r, xt_i), unroll=max(1, 8 // S)
        )
        if S > 1:  # [n/S, ..., S, 2] → [..., n, 2]
            packed = jnp.moveaxis(packed, 0, -3)
            packed = packed.reshape(packed.shape[:-3] + (n, 2))
        else:
            packed = jnp.moveaxis(packed, 0, -2)
        y = (
            jax.lax.complex(packed[..., 0], packed[..., 1])
            if is_c
            else packed[..., 0].astype(x.dtype)
        )
        return y, self.replace(
            g=g, y2_prime=y2p, squelch_mode=mode, squelch_timer=timer
        )

    __call__ = execute_block

    def execute(self, x):
        """Single-sample parity (agc.rs:71)."""
        y, q = self.execute_block(jnp.asarray(x)[..., None])
        return y[..., 0], q
