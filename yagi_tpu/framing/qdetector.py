"""qdetector: known-sequence burst detector / synchronizer front-end.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``qdetector``/``qdsync`` rows in LIQUID_COMPAT.md). Behavioral spec is
liquid-dsp's qdetector_cccf: given a known template sequence, find it in a
received buffer and estimate timing offset (to sub-sample resolution),
carrier frequency offset, carrier phase, and channel gain.

Block-parallel: detection is one batched computation — FFT cross-correlation of
the buffer against a *bank of carrier-offset hypotheses* (the template
pre-rotated by each trial dphi), evaluated as a single [n_dphi, Nfft]
frequency-domain product and inverse FFT. Peak search is an argmax over
the 2-D surface; sub-sample timing and sub-bin frequency come from
quadratic interpolation around the peak in each axis. Everything jits;
no data-dependent control flow until the final host-side threshold test.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..errors import ConfigError

__all__ = ["QDetector"]


@partial(jax.jit, static_argnames=("nfft",))
def _xcorr_surface(x, s_bank, nfft):
    """|cross-correlation| surface over (dphi hypothesis, lag).

    x      [N]        received buffer
    s_bank [H, L]     template rotated by each dphi hypothesis
    returns (R [H, nfft] complex, norm scalar)
    """
    X = jnp.fft.fft(x, nfft)
    S = jnp.fft.fft(s_bank, nfft, axis=-1)
    R = jnp.fft.ifft(X[None, :] * jnp.conj(S), axis=-1)
    return R


def _quad_peak(ym1, y0, yp1):
    """Offset in [-0.5, 0.5] of the vertex of the parabola through 3 pts."""
    denom = ym1 - 2.0 * y0 + yp1
    off = jnp.where(jnp.abs(denom) > 1e-12,
                    0.5 * (ym1 - yp1) / denom, 0.0)
    return jnp.clip(off, -0.5, 0.5)


class QDetector:
    """Burst detector for a known complex template."""

    def __init__(self, sequence, threshold: float = 0.5,
                 dphi_max: float = 0.02, n_dphi: int = 9):
        sequence = np.asarray(sequence, dtype=np.complex64).ravel()
        if sequence.size < 8:
            raise ConfigError(
                f"sequence length ({sequence.size}) must be >= 8")
        if not 0.0 < threshold < 2.0:
            raise ConfigError(f"threshold ({threshold}) must be in (0,2)")
        if n_dphi < 1 or n_dphi % 2 == 0:
            raise ConfigError(f"n_dphi ({n_dphi}) must be odd and >= 1")
        self.s = sequence
        self.L = sequence.size
        self.threshold = float(threshold)
        self.dphis = np.linspace(-dphi_max, dphi_max, n_dphi) \
            if n_dphi > 1 else np.zeros(1)
        n = np.arange(self.L)
        # hypothesis h matches a received offset of +dphis[h]: the conjugate
        # in the correlation cancels exp(+j*dphi*n) exactly at the true CFO
        rot = np.exp(1j * self.dphis[:, None] * n[None, :])
        self._bank = (sequence[None, :] * rot).astype(np.complex64)  # [H, L]
        self._e_s = float(np.sum(np.abs(sequence) ** 2))

    def detect(self, x):
        """Search buffer ``x`` for the template.

        Returns None below threshold, else a dict with:
        ``tau`` (start offset in samples, sub-sample resolution),
        ``dphi`` (carrier offset rad/sample), ``phi`` (carrier phase at
        tau), ``gamma`` (linear channel gain), ``rxy`` (normalized
        correlation peak in [0,1])."""
        x = np.asarray(x, dtype=np.complex64).ravel()
        N = x.size
        if N < self.L:
            raise ConfigError(f"buffer ({N}) shorter than sequence ({self.L})")
        nfft = 1 << int(np.ceil(np.log2(N + self.L)))
        R = np.asarray(_xcorr_surface(jnp.asarray(x),
                                      jnp.asarray(self._bank), nfft))
        mag = np.abs(R)
        n_lags = N - self.L + 1
        mag_v = mag[:, :n_lags]
        h, lag = np.unravel_index(np.argmax(mag_v), mag_v.shape)
        peak = mag_v[h, lag]
        # normalized correlation vs local energy
        e_x = float(np.sum(np.abs(x[lag: lag + self.L]) ** 2)) + 1e-20
        rxy = peak / np.sqrt(self._e_s * e_x)
        if rxy < self.threshold:
            return None
        # sub-sample timing from the lag axis
        ym1 = mag[h, lag - 1] if lag > 0 else peak
        yp1 = mag[h, lag + 1] if lag + 1 < nfft else peak
        dtau = float(_quad_peak(ym1, peak, yp1))
        # sub-bin carrier offset from the hypothesis axis
        if len(self.dphis) > 1:
            hm1 = mag[h - 1, lag] if h > 0 else peak
            hp1 = mag[h + 1, lag] if h + 1 < len(self.dphis) else peak
            dh = float(_quad_peak(hm1, peak, hp1))
            step = self.dphis[1] - self.dphis[0]
            dphi = float(self.dphis[h] + dh * step)
        else:
            dphi = 0.0
        phi = float(np.angle(R[h, lag]))
        gamma = float(peak / self._e_s)
        return {
            "tau": float(lag) + dtau,
            "dphi": dphi,
            "phi": phi,
            "gamma": gamma,
            "rxy": float(rxy),
        }
