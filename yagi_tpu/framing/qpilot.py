"""qpilotgen / qpilotsync: pilot-assisted carrier recovery for packets.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``qpilotgen``/``qpilotsync`` rows in LIQUID_COMPAT.md:1188-1197).
Behavioral spec is liquid-dsp: the generator interleaves known QPSK pilot
symbols (from an m-sequence) every ``pilot_spacing`` positions into a
payload symbol stream; the synchronizer estimates channel gain, carrier
frequency offset, and carrier phase from the received pilots and corrects
the payload.

Block-parallel: the CFO estimate is one zero-padded FFT over the pilot
correlation sequence (argmax + quadratic interpolation for sub-bin
resolution); gain/phase are weighted reductions; the payload correction is
a single vector rotate. Everything is batched block math — no loops.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..errors import ConfigError
from ..sequence.msequence import MSequence

__all__ = ["QPilotGen", "QPilotSync"]


def _pilot_layout(payload_len: int, pilot_spacing: int):
    """Number of pilots and frame length (liquid qpilotgen_create)."""
    div = pilot_spacing - 1
    num_pilots = (payload_len + div - 1) // div
    return num_pilots, payload_len + num_pilots


def _pilot_sequence(num_pilots: int) -> np.ndarray:
    """QPSK pilots from a default m-sequence (liquid's generator)."""
    ms = MSequence.create_default(7)
    sym = np.empty(num_pilots, dtype=np.complex64)
    s22 = np.float32(np.sqrt(0.5))
    for i in range(num_pilots):
        b0 = ms.advance()
        b1 = ms.advance()
        sym[i] = ((1.0 - 2.0 * b0) + 1j * (1.0 - 2.0 * b1)) * s22
    return sym


class QPilotGen:
    """Insert pilot symbols into a payload symbol stream."""

    def __init__(self, payload_len: int, pilot_spacing: int):
        if payload_len < 1:
            raise ConfigError(f"payload length ({payload_len}) must be >= 1")
        if pilot_spacing < 2:
            raise ConfigError(
                f"pilot spacing ({pilot_spacing}) must be >= 2")
        self.payload_len = payload_len
        self.pilot_spacing = pilot_spacing
        self.num_pilots, self.frame_len = _pilot_layout(
            payload_len, pilot_spacing)
        self.pilots = _pilot_sequence(self.num_pilots)
        # index maps, computed once
        pilot_idx = np.arange(self.num_pilots) * pilot_spacing
        mask = np.zeros(self.frame_len, dtype=bool)
        mask[pilot_idx] = True
        self._pilot_idx = pilot_idx
        self._payload_idx = np.nonzero(~mask)[0]

    def get_frame_len(self) -> int:
        return self.frame_len

    def execute(self, payload) -> np.ndarray:
        """payload symbols [payload_len] -> frame [frame_len]."""
        payload = np.asarray(payload, dtype=np.complex64).ravel()
        if payload.size != self.payload_len:
            raise ConfigError(
                f"payload length {payload.size} != {self.payload_len}")
        frame = np.empty(self.frame_len, dtype=np.complex64)
        frame[self._pilot_idx] = self.pilots
        frame[self._payload_idx] = payload
        return frame


class QPilotSync:
    """Recover gain/CFO/phase from pilots and correct the payload.

    ``execute(frame)`` returns ``(payload, info)`` with info keys
    ``dphi`` (rad/symbol), ``phi``, ``gain``, ``evm`` (pilot rms error).
    """

    def __init__(self, payload_len: int, pilot_spacing: int,
                 nfft_factor: int = 16):
        if payload_len < 1:
            raise ConfigError(f"payload length ({payload_len}) must be >= 1")
        if pilot_spacing < 2:
            raise ConfigError(
                f"pilot spacing ({pilot_spacing}) must be >= 2")
        self.payload_len = payload_len
        self.pilot_spacing = pilot_spacing
        self.num_pilots, self.frame_len = _pilot_layout(
            payload_len, pilot_spacing)
        self.pilots = _pilot_sequence(self.num_pilots)
        pilot_idx = np.arange(self.num_pilots) * pilot_spacing
        mask = np.zeros(self.frame_len, dtype=bool)
        mask[pilot_idx] = True
        self._pilot_idx = pilot_idx
        self._payload_idx = np.nonzero(~mask)[0]
        self.nfft = max(64, int(2 ** np.ceil(
            np.log2(self.num_pilots * nfft_factor))))

    def get_frame_len(self) -> int:
        return self.frame_len

    def execute(self, frame):
        frame = np.asarray(frame, dtype=np.complex64).ravel()
        if frame.size != self.frame_len:
            raise ConfigError(
                f"frame length {frame.size} != {self.frame_len}")
        rx_pilots = frame[self._pilot_idx]
        # de-rotate by the known pilots: v[i] = gain * exp(j(dphi*i*G + phi))
        v = rx_pilots * np.conj(self.pilots)
        V = np.asarray(jnp.abs(jnp.fft.fft(jnp.asarray(v), self.nfft)))
        i0 = int(np.argmax(V))
        # quadratic interpolation around the peak (sub-bin CFO)
        ym1, y0, yp1 = V[(i0 - 1) % self.nfft], V[i0], V[(i0 + 1) % self.nfft]
        denom = ym1 - 2.0 * y0 + yp1
        d = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-12 else 0.0
        d = float(np.clip(d, -0.5, 0.5))
        bin_f = i0 + d
        if bin_f > self.nfft / 2:
            bin_f -= self.nfft
        # frequency per *pilot index*, convert to per frame symbol
        dphi = 2.0 * np.pi * bin_f / (self.nfft * self.pilot_spacing)
        # remove CFO then estimate phase + gain from the coherent sum
        n_pil = self._pilot_idx.astype(np.float64)
        w = v * np.exp(-1j * dphi * n_pil)
        s = np.sum(w)
        phi = float(np.angle(s))
        gain = float(np.abs(s) / np.sum(np.abs(self.pilots) ** 2))
        gain = max(gain, 1e-9)
        # correct the whole frame
        n = np.arange(self.frame_len, dtype=np.float64)
        corr = frame * np.exp(-1j * (dphi * n + phi)) / gain
        payload = corr[self._payload_idx].astype(np.complex64)
        evm = float(np.sqrt(np.mean(
            np.abs(corr[self._pilot_idx] - self.pilots) ** 2)))
        return payload, {"dphi": float(dphi), "phi": phi, "gain": gain,
                         "evm": evm}
