"""FM broadcast receiver chain: mono and pilot-tone stereo decoding.

BASELINE.json config[2] ("freqdem + de-emphasis IIR + pilot-tone stereo
separation"), assembled per SURVEY.md §3.6 from framework parts:

  IQ → Freqdem → composite m(t)
    mono:   lowpass(m)                                  (L+R)/2
    pilot:  complex bandpass at f_p → analytic e^{jθ}
    stereo: 2·Re[lowpass(m · e^{-j2θ})]                 (L-R)/2
    L, R  = mono ± stereo, then de-emphasis IIR

All frequencies are normalized to the composite sample rate (broadcast FM:
f_p = 19 kHz / fs). The pilot's analytic signal comes from a complex-tap FIR
(kaiser lowpass mixed to +f_p), and the 38 kHz subcarrier is its normalized
square — phase-exact doubling without a PLL settling time.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..design import fir_design_kaiser
from ..filter import FirFilter, IirFilter
from ..modem import Freqdem

__all__ = ["FmStereoRx"]


def _complex_bandpass(n: int, fc_width: float, f0: float) -> np.ndarray:
    """Complex-tap bandpass: kaiser lowpass of half-width fc mixed to +f0."""
    h = fir_design_kaiser(n, fc_width, 60.0, 0.0) * (2.0 * fc_width)
    t = np.arange(n) - (n - 1) / 2.0
    return (h * np.exp(2j * np.pi * f0 * t)).astype(np.complex64)


@struct.pytree
class FmStereoRx:
    """FM stereo receiver state."""

    f_pilot: float = struct.static_field()
    demod: Freqdem = struct.field()
    align: FirFilter = struct.field()  # pure delay matching pilot_bp's group delay
    mono_lp: FirFilter = struct.field()  # audio lowpass for L+R
    diff_lp: FirFilter = struct.field()  # complex lowpass for (L-R) recovery
    pilot_bp: FirFilter = struct.field()  # complex bandpass at f_pilot
    deemph_l: IirFilter = struct.field()
    deemph_r: IirFilter = struct.field()

    @classmethod
    def create(
        cls,
        kf: float = 0.5,
        f_pilot: float = 0.095,  # 19 kHz at fs = 200 kHz
        f_audio: float = 0.075,  # 15 kHz audio bandwidth
        deemph_alpha: float = 0.05,
        n_taps: int = 129,
        batch_shape: tuple = (),
    ) -> "FmStereoRx":
        demod = Freqdem.create(kf, batch_shape=batch_shape)
        h_audio = fir_design_kaiser(n_taps, f_audio, 60.0, 0.0) * (2 * f_audio)
        mono_lp = FirFilter.create(
            h_audio.astype(np.float32), batch_shape=batch_shape, dtype=jnp.float32
        )
        diff_lp = FirFilter.create(
            h_audio.astype(np.float32), batch_shape=batch_shape, dtype=jnp.complex64
        )
        pilot_bp = FirFilter.create(
            _complex_bandpass(n_taps, 0.008, f_pilot),
            batch_shape=batch_shape,
            dtype=jnp.complex64,
        )
        # delay-match the composite to the pilot filter's group delay so the
        # regenerated 38 kHz subcarrier is phase-aligned with the composite
        h_delay = np.zeros(n_taps, dtype=np.float32)
        h_delay[(n_taps - 1) // 2] = 1.0
        align = FirFilter.create(h_delay, batch_shape=batch_shape, dtype=jnp.float32)
        # single-pole de-emphasis: H(z) = α/(1-(1-α)z⁻¹), run via the
        # log-depth parallel recurrence (filter/_linrec.py) — the only
        # sequential-scan stage in this chain
        mk_deemph = lambda: IirFilter.create(  # noqa: E731
            [deemph_alpha], [1.0, -(1.0 - deemph_alpha)],
            batch_shape=batch_shape, dtype=jnp.float32,
        ).parallelize()
        return cls(
            f_pilot=float(f_pilot),
            demod=demod,
            align=align,
            mono_lp=mono_lp,
            diff_lp=diff_lp,
            pilot_bp=pilot_bp,
            deemph_l=mk_deemph(),
            deemph_r=mk_deemph(),
        )

    def step(self, iq) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, "FmStereoRx"]:
        """Decode one IQ block → (left, right, pilot_level, new state)."""
        iq = jnp.asarray(iq)
        m, demod = self.demod.demodulate(iq)

        # analytic pilot (delay D) and delay-matched composite
        z, pilot_bp = self.pilot_bp.execute_block(m.astype(jnp.complex64))
        m_d, align = self.align.execute_block(m)
        mag = jnp.abs(z)
        unit = z / jnp.maximum(mag, 1e-9)
        carrier2 = unit * unit  # e^{+j2θ}, phase-exact 38 kHz subcarrier

        mono, mono_lp = self.mono_lp.execute_block(m_d)
        d, diff_lp = self.diff_lp.execute_block(
            m_d.astype(jnp.complex64) * jnp.conj(carrier2)
        )
        stereo = 2.0 * d.real

        left = mono + stereo
        right = mono - stereo
        left, deemph_l = self.deemph_l.execute_block(left)
        right, deemph_r = self.deemph_r.execute_block(right)
        pilot_level = jnp.mean(mag, axis=-1) * 2.0

        return left, right, pilot_level, self.replace(
            demod=demod,
            align=align,
            mono_lp=mono_lp,
            diff_lp=diff_lp,
            pilot_bp=pilot_bp,
            deemph_l=deemph_l,
            deemph_r=deemph_r,
        )

    __call__ = step
