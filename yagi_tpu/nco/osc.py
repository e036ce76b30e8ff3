"""Numerically-controlled oscillator, VCO, PLL, and mixers.

Behavioral spec: /root/reference/src/nco/{osc.rs,nco.rs,vco.rs}. The phase is
a wrapping u32 accumulator (osc.rs:27-33, constrain osc.rs:191-200). Three
synthesis modes:

  "nco"   — 1024-entry sine LUT, rounded nearest index (nco.rs:47-51)
  "vco"   — 1024-entry {value, skew} LUT with linear interpolation (vco.rs)
  "exact" — device sin/cos (no table; higher purity, no gather — the
            recommended mode for new code)

Block mixing vectorizes the phase ramp: θ_n = θ0 + n·dθ in wrapping uint32,
then one fused multiply — bit-identical to stepping per sample
(osc.rs:161-188).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError

__all__ = ["Osc", "constrain_phase"]

_LUT_BITS = 10
_LUT_SIZE = 1 << _LUT_BITS
_TWO_PI = 2.0 * np.pi
_PLL_BANDWIDTH_DEFAULT = 0.1


def constrain_phase(theta) -> jnp.ndarray:
    """radians → wrapping u32 phase (osc.rs:191-200)."""
    t = jnp.asarray(theta, dtype=jnp.float32)
    t = jnp.mod(t, _TWO_PI)
    t = jnp.where(t < 0, t + _TWO_PI, t)
    return (t / _TWO_PI * jnp.float32(np.float32(np.uint32(0xFFFFFFFF)))).astype(
        jnp.uint32
    )


def _nco_table() -> np.ndarray:
    i = np.arange(_LUT_SIZE)
    return np.sin(2.0 * np.pi * i / _LUT_SIZE).astype(np.float32)


def _vco_tables() -> tuple[np.ndarray, np.ndarray]:
    """{value, skew} tables built exactly as vco.rs:34-77."""
    qsize = _LUT_SIZE >> 2
    hsize = _LUT_SIZE >> 1
    value = np.zeros(_LUT_SIZE, dtype=np.float32)
    skew = np.zeros(_LUT_SIZE, dtype=np.float32)

    def fp_sin(theta_u32: int) -> float:
        return np.float32(np.sin(np.float32(theta_u32) * np.pi / 2147483648.0))

    d_theta = 0xFFFFFFFF // _LUT_SIZE
    theta = 0
    for i in range(qsize):
        v = fp_sin(theta)
        nv = fp_sin(theta + d_theta)
        s = (nv - v) / np.float32(d_theta)
        value[i] = v
        skew[i] = s
        value[i + hsize] = -v
        skew[i + hsize] = -s
        theta = (theta + d_theta) & 0xFFFFFFFF

    value[qsize] = 1.0
    skew[qsize] = -skew[qsize - 1]
    value[qsize + hsize] = -1.0
    skew[qsize + hsize] = skew[qsize - 1]
    for i in range(1, qsize):
        value[i + qsize] = value[qsize - i]
        skew[i + qsize] = -skew[qsize - i - 1]
        value[i + qsize + hsize] = -value[qsize - i]
        skew[i + qsize + hsize] = skew[qsize - i - 1]
    return value, skew


_NCO_TAB = None
_VCO_TABS = None


def _get_nco_tab():
    global _NCO_TAB
    if _NCO_TAB is None:
        _NCO_TAB = jnp.asarray(_nco_table())
    return _NCO_TAB


def _get_vco_tabs():
    global _VCO_TABS
    if _VCO_TABS is None:
        v, s = _vco_tables()
        _VCO_TABS = (jnp.asarray(v), jnp.asarray(s))
    return _VCO_TABS


def _sin_cos(theta: jnp.ndarray, mode: str):
    """(sin, cos) of u32 phase per the selected synthesis mode."""
    if mode == "exact":
        t = theta.astype(jnp.float32) * jnp.float32(_TWO_PI / 4294967296.0)
        return jnp.sin(t), jnp.cos(t)
    if mode == "nco":
        tab = _get_nco_tab()
        idx = ((theta + jnp.uint32(1 << (32 - _LUT_BITS - 1))) >> (32 - _LUT_BITS)) & (
            _LUT_SIZE - 1
        )
        idx_pi2 = (idx + (_LUT_SIZE >> 2)) & (_LUT_SIZE - 1)
        return tab[idx], tab[idx_pi2]
    if mode == "vco":
        value, skew = _get_vco_tabs()
        accum_mask = jnp.uint32((1 << (32 - _LUT_BITS)) - 1)

        def interp(th):
            idx = (th >> (32 - _LUT_BITS)) & (_LUT_SIZE - 1)
            acc = (th & accum_mask).astype(jnp.float32)
            return value[idx] + acc * skew[idx]

        theta_pi2 = theta + jnp.uint32(1 << 30)
        return interp(theta), interp(theta_pi2)
    raise ConfigError(f"unknown oscillator mode {mode!r}")


@struct.pytree
class Osc:
    """Oscillator state (osc.rs:27-33)."""

    mode: str = struct.static_field()
    theta: jnp.ndarray = struct.field()  # uint32 phase
    d_theta: jnp.ndarray = struct.field()  # uint32 frequency
    alpha: jnp.ndarray = struct.field()  # PLL bandwidth
    beta: jnp.ndarray = struct.field()  # sqrt(bandwidth)

    @classmethod
    def create(cls, mode: str = "nco", batch_shape: tuple = ()) -> "Osc":
        if mode not in ("nco", "vco", "exact"):
            raise ConfigError(f"unknown oscillator mode {mode!r}")
        bw = _PLL_BANDWIDTH_DEFAULT
        return cls(
            mode=mode,
            theta=jnp.zeros(batch_shape, dtype=jnp.uint32),
            d_theta=jnp.zeros(batch_shape, dtype=jnp.uint32),
            alpha=jnp.full(batch_shape, bw, dtype=jnp.float32),
            beta=jnp.full(batch_shape, np.sqrt(bw), dtype=jnp.float32),
        )

    # ----------------------------------------------------------------- control
    def reset(self) -> "Osc":
        return self.replace(
            theta=jnp.zeros_like(self.theta), d_theta=jnp.zeros_like(self.d_theta)
        )

    def set_frequency(self, dtheta) -> "Osc":
        """Frequency in radians/sample (osc.rs:66)."""
        return self.replace(d_theta=constrain_phase(dtheta))

    def adjust_frequency(self, df) -> "Osc":
        return self.replace(d_theta=self.d_theta + constrain_phase(df))

    def set_phase(self, phi) -> "Osc":
        return self.replace(theta=constrain_phase(phi))

    def adjust_phase(self, dphi) -> "Osc":
        return self.replace(theta=self.theta + constrain_phase(dphi))

    def step(self) -> "Osc":
        """Advance one sample (osc.rs:86)."""
        return self.replace(theta=self.theta + self.d_theta)

    def get_phase(self) -> jnp.ndarray:
        """Phase in [0, 2π) (osc.rs:91)."""
        return self.theta.astype(jnp.float32) * jnp.float32(_TWO_PI / 4294967296.0)

    def get_frequency(self) -> jnp.ndarray:
        """Frequency in (-π, π] (osc.rs:96)."""
        d = self.d_theta.astype(jnp.float32) * jnp.float32(_TWO_PI / 4294967296.0)
        return jnp.where(d > np.pi, d - _TWO_PI, d)

    # ------------------------------------------------------------- synthesis
    def sin(self):
        return _sin_cos(self.theta, self.mode)[0]

    def cos(self):
        return _sin_cos(self.theta, self.mode)[1]

    def sin_cos(self):
        return _sin_cos(self.theta, self.mode)

    def cexp(self):
        """exp(jθ) (osc.rs:130)."""
        s, c = self.sin_cos()
        return jax_complex(c, s)

    # ------------------------------------------------------------------- PLL
    def pll_set_bandwidth(self, bw) -> "Osc":
        """2nd-order loop gains α=bw, β=√bw (osc.rs:138-144)."""
        bw_arr = jnp.asarray(bw, dtype=jnp.float32)
        return self.replace(alpha=bw_arr, beta=jnp.sqrt(bw_arr))

    def pll_step(self, dphi) -> "Osc":
        """Phase-detector update (osc.rs:147-150)."""
        return self.adjust_frequency(dphi * self.alpha).adjust_phase(dphi * self.beta)

    # ---------------------------------------------------------------- mixing
    def _phase_ramp(self, n: int) -> jnp.ndarray:
        idx = jnp.arange(n, dtype=jnp.uint32)
        return self.theta[..., None] + idx * self.d_theta[..., None]

    def mix_up(self, x):
        """Single-sample up-mix (osc.rs:155)."""
        s, c = self.sin_cos()
        return x * jax_complex(c, s)

    def mix_down(self, x):
        """Single-sample down-mix (osc.rs:173)."""
        s, c = self.sin_cos()
        return x * jax_complex(c, -s)

    def mix_block_up(self, x) -> tuple[jnp.ndarray, "Osc"]:
        """Block up-mix; advances phase by N samples (osc.rs:161)."""
        x = jnp.asarray(x)
        n = x.shape[-1]
        thetas = self._phase_ramp(n)
        s, c = _sin_cos(thetas, self.mode)
        y = x * jax_complex(c, s)
        return y, self.replace(theta=self.theta + jnp.uint32(n) * self.d_theta)

    def mix_block_down(self, x) -> tuple[jnp.ndarray, "Osc"]:
        """Block down-mix (osc.rs:179)."""
        x = jnp.asarray(x)
        n = x.shape[-1]
        thetas = self._phase_ramp(n)
        s, c = _sin_cos(thetas, self.mode)
        y = x * jax_complex(c, -s)
        return y, self.replace(theta=self.theta + jnp.uint32(n) * self.d_theta)

    def mix_block_up_n(self, x, n_valid) -> tuple[jnp.ndarray, "Osc"]:
        """Up-mix a fixed-capacity buffer whose first ``n_valid`` samples are
        real; the phase advances by n_valid (for variable-rate stages)."""
        x = jnp.asarray(x)
        thetas = self._phase_ramp(x.shape[-1])
        s, c = _sin_cos(thetas, self.mode)
        y = x * jax_complex(c, s)
        adv = jnp.asarray(n_valid).astype(jnp.uint32) * self.d_theta
        return y, self.replace(theta=self.theta + adv)

    def mix_block_down_n(self, x, n_valid) -> tuple[jnp.ndarray, "Osc"]:
        """Down-mix variant of :meth:`mix_block_up_n`."""
        x = jnp.asarray(x)
        thetas = self._phase_ramp(x.shape[-1])
        s, c = _sin_cos(thetas, self.mode)
        y = x * jax_complex(c, -s)
        adv = jnp.asarray(n_valid).astype(jnp.uint32) * self.d_theta
        return y, self.replace(theta=self.theta + adv)


def jax_complex(re, im) -> jnp.ndarray:
    return jax.lax.complex(re, im)
