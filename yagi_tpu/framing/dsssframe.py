"""dsssframe64: direct-sequence spread-spectrum burst frame.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``dsssframe64``/``dsssframesync`` rows in LIQUID_COMPAT.md:1037-1049).
Behavioral spec is liquid-dsp's dsssframe64gen/dsssframe64sync: the frame64
format (protected 8-byte header + 64-byte payload, QPSK) with every data
symbol spread by a binary PN chip sequence, giving ~10*log10(sf) dB of
processing gain so frames decode well below 0 dB SNR.

Block-parallel: spreading is one outer product (symbols [S] x chips [sf] ->
[S, sf] reshaped to a chip stream); despreading is one matmul of the
chip-rate matrix against the conjugate PN vector — both map straight onto
one matmul for batched links. Detection/carrier recovery reuse the QDetector
FFT correlation bank over the chip-shaped preamble.
"""

from __future__ import annotations

import numpy as np

from ..design import fir as fir_design
from ..errors import ConfigError
from ..sequence.msequence import MSequence
from .qdetector import QDetector
from .qpacketmodem import QPacketModem

__all__ = ["DsssFrameGen64", "DsssFrameSync64"]

_K = 2          # samples/chip
_M = 7          # pulse semi-length in chips
_BETA = 0.3
_HEADER_LEN = 8
_PAYLOAD_LEN = 64
_PRE_CHIPS = 256  # preamble chips


def _pulse() -> np.ndarray:
    h = fir_design.fir_design_arkaiser(_K, _M, _BETA, 0.0)
    return (h / np.sqrt(np.sum(h * h) * _K)).astype(np.float32)


def _pn(n: int, m: int = 11) -> np.ndarray:
    ms = MSequence.create_default(m)
    bits = np.array([ms.advance() for _ in range(n)], dtype=np.float32)
    return (1.0 - 2.0 * bits).astype(np.complex64)


def _header_pm() -> QPacketModem:
    return QPacketModem(_HEADER_LEN, crc="crc32", fec0="golay2412",
                        fec1="none", mod_scheme="qpsk")


def _payload_pm() -> QPacketModem:
    return QPacketModem(_PAYLOAD_LEN, crc="crc32", fec0="hamming128",
                        fec1="none", mod_scheme="qpsk")


def _shape(chips: np.ndarray) -> np.ndarray:
    h = _pulse()
    up = np.zeros(chips.size * _K, dtype=np.complex64)
    up[:: _K] = chips
    return np.convolve(up, h)[: chips.size * _K].astype(np.complex64)


class DsssFrameGen64:
    """DSSS burst frame generator (liquid ``dsssframe64gen``).

    ``sf`` is the spreading factor (chips/symbol)."""

    def __init__(self, sf: int = 8):
        if sf < 2 or sf > 256:
            raise ConfigError(f"spreading factor ({sf}) must be in [2,256]")
        self.sf = sf
        self.header_pm = _header_pm()
        self.payload_pm = _payload_pm()
        self.pn = _pn(sf, m=7 if sf <= 64 else 11)
        self.preamble = _pn(_PRE_CHIPS, m=11)
        nsym = self.header_pm.get_frame_len() + self.payload_pm.get_frame_len()
        self.frame_len = (_PRE_CHIPS + nsym * sf + 2 * _M) * _K

    def execute(self, header, payload) -> np.ndarray:
        """header [8] bytes, payload [64] bytes -> samples [frame_len]."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        if header.size != _HEADER_LEN:
            raise ConfigError(f"header length {header.size} != {_HEADER_LEN}")
        if payload.size != _PAYLOAD_LEN:
            raise ConfigError(
                f"payload length {payload.size} != {_PAYLOAD_LEN}")
        syms = np.concatenate([self.header_pm.encode(header),
                               self.payload_pm.encode(payload)])
        # spread: one outer product [S, sf] -> chip stream
        chips = (syms[:, None] * self.pn[None, :]).reshape(-1)
        chips = np.concatenate([self.preamble, chips,
                                np.zeros(2 * _M, np.complex64)])
        return _shape(chips)


class DsssFrameSync64:
    """DSSS burst frame synchronizer (liquid ``dsssframe64sync``)."""

    def __init__(self, sf: int = 8, threshold: float = 0.35,
                 dphi_max: float = 0.01, n_dphi: int = 21):
        if sf < 2 or sf > 256:
            raise ConfigError(f"spreading factor ({sf}) must be in [2,256]")
        self.sf = sf
        self.header_pm = _header_pm()
        self.payload_pm = _payload_pm()
        self.pn = _pn(sf, m=7 if sf <= 64 else 11)
        self.preamble = _pn(_PRE_CHIPS, m=11)
        self.detector = QDetector(_shape(self.preamble),
                                  threshold=threshold, dphi_max=dphi_max,
                                  n_dphi=n_dphi)
        self._h = _pulse()
        self._nsym = (self.header_pm.get_frame_len()
                      + self.payload_pm.get_frame_len())

    def execute(self, x):
        """Search buffer; None or dict like FrameSync64's."""
        x = np.asarray(x, dtype=np.complex64).ravel()
        det = self.detector.detect(x)
        if det is None:
            return None
        tau, dphi, phi, gamma = (det["tau"], det["dphi"], det["phi"],
                                 det["gamma"])
        n = np.arange(x.size)
        y = x * np.exp(-1j * (dphi * n + phi)) / max(gamma, 1e-9)
        i0 = int(np.floor(tau))
        frac = tau - i0
        if frac > 1e-6:
            f = np.fft.fftfreq(y.size)
            y = np.fft.ifft(np.fft.fft(y) * np.exp(2j * np.pi * f * frac))
        z = np.convolve(y, self._h)
        d = self._h.size - 1
        nchip = _PRE_CHIPS + self._nsym * self.sf
        idx = i0 + d + _K * np.arange(nchip)
        if idx[-1] >= z.size:
            return None
        chips = z[idx].astype(np.complex64)
        # residual carrier fit over preamble chips
        pre = self.preamble
        e = chips[:_PRE_CHIPS] * np.conj(pre)
        w = np.abs(e)
        ang = np.angle(e)
        i = np.arange(_PRE_CHIPS, dtype=np.float64)
        W = np.sum(w)
        den = max(np.sum(w * i * i) * W - np.sum(w * i) ** 2, 1e-12)
        b = (np.sum(w * i * ang) * W - np.sum(w * i) * np.sum(w * ang)) / den
        a = (np.sum(w * ang) - b * np.sum(w * i)) / max(W, 1e-12)
        amp = W / max(np.sum(np.abs(pre) ** 2), 1e-12)
        kk = np.arange(nchip, dtype=np.float64)
        chips = chips * np.exp(-1j * (a + b * kk)) / max(amp, 1e-9)
        # despread: [S, sf] @ conj(pn) / sf — the processing-gain matmul
        data = chips[_PRE_CHIPS:].reshape(self._nsym, self.sf)
        syms = (data @ np.conj(self.pn)) / self.sf
        # despread symbols have high post-gain SNR: strip residual CFO with
        # a blind 4th-power estimate, then decision-directed phase tracking
        from ..modem.modem import Modem
        from ._carrier import dd_track, mth_power_cfo
        dphi_sym = mth_power_cfo(syms, m=4)
        syms = syms * np.exp(-1j * dphi_sym * np.arange(syms.size))
        syms = dd_track(syms, Modem.create("qpsk"), chunk=32)
        hlen = self.header_pm.get_frame_len()
        header, hok = self.header_pm.decode_soft(syms[:hlen])
        payload, pok = self.payload_pm.decode_soft(syms[hlen:])
        err = chips[:_PRE_CHIPS] - pre
        evm_db = 10.0 * np.log10(np.mean(np.abs(err) ** 2) + 1e-20)
        return {"header": header, "header_valid": bool(hok),
                "payload": payload, "payload_valid": bool(pok),
                "stats": {"rxy": det["rxy"], "tau": tau,
                          "dphi": dphi + b / _K, "phi": phi,
                          "gamma": gamma, "evm_db": float(evm_db)}}
