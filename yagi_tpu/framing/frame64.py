"""frame64: fixed-configuration burst frame generator + synchronizer.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``framegen64``/``framesync64`` rows in LIQUID_COMPAT.md:1009-1283).
Behavioral spec is liquid-dsp's frame64: a fixed burst format with a
64-symbol BPSK p/n preamble, a protected 8-byte header, a protected
64-byte payload, root-Nyquist pulse shaping at k=2 samples/symbol, and a
synchronizer that recovers timing (sub-sample), carrier frequency/phase,
and gain from a raw sample buffer, then decodes header and payload with
CRC validation.

The wire format is self-consistent to this framework (liquid's exact bit
layout is not a published interop standard); the *capabilities* match:
detection from noise at unknown delay/CFO/phase/gain, soft-decision FEC
decode, and per-frame stats (EVM, RSSI, CFO estimate).

Block-parallel: detection is the QDetector FFT correlation bank; carrier and
timing correction are closed-form vector ops over the whole burst (no
per-sample feedback loops — a burst is a block, so block math wins);
matched filtering is one XLA convolution.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError
from ..design import fir as fir_design
from ..sequence.msequence import MSequence
from .qdetector import QDetector
from .qpacketmodem import QPacketModem

__all__ = ["FrameGen64", "FrameSync64", "FRAME64_LEN"]

_K = 2          # samples/symbol
_M = 7          # pulse semi-length in symbols
_BETA = 0.3     # excess bandwidth


def _pulse() -> np.ndarray:
    h = fir_design.fir_design_arkaiser(_K, _M, _BETA, 0.0)
    return (h / np.sqrt(np.sum(h * h) * _K)).astype(np.float32)


def _preamble_symbols() -> np.ndarray:
    ms = MSequence.create_default(7)
    bits = np.array([ms.advance() for _ in range(64)], dtype=np.float32)
    return (1.0 - 2.0 * bits).astype(np.complex64)  # BPSK +/-1


_HEADER_LEN = 8
_PAYLOAD_LEN = 64


def _header_pm() -> QPacketModem:
    return QPacketModem(_HEADER_LEN, crc="crc32", fec0="golay2412",
                        fec1="none", mod_scheme="qpsk")


def _payload_pm() -> QPacketModem:
    return QPacketModem(_PAYLOAD_LEN, crc="crc32", fec0="hamming128",
                        fec1="conv27p23", mod_scheme="qpsk")


import functools


@functools.lru_cache(maxsize=None)
def _frame_symbols_len() -> int:
    return 64 + _header_pm().get_frame_len() + _payload_pm().get_frame_len() \
        + 2 * _M


def frame64_len() -> int:
    """Samples per frame64 (computed lazily: no jax work at import time)."""
    return _frame_symbols_len() * _K


def __getattr__(name):
    if name == "FRAME64_LEN":
        return frame64_len()
    raise AttributeError(name)


def _shape(symbols: np.ndarray) -> np.ndarray:
    """Zero-stuff to k samples/symbol and pulse-shape (one convolution)."""
    h = _pulse()
    up = np.zeros(symbols.size * _K, dtype=np.complex64)
    up[:: _K] = symbols
    return np.convolve(up, h)[: symbols.size * _K].astype(np.complex64)


class FrameGen64:
    """Burst frame generator (liquid ``framegen64``)."""

    def __init__(self):
        self.header_pm = _header_pm()
        self.payload_pm = _payload_pm()
        self.frame_len = frame64_len()

    def execute(self, header, payload) -> np.ndarray:
        """header [8] bytes, payload [64] bytes -> samples [FRAME64_LEN]."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        if header.size != _HEADER_LEN:
            raise ConfigError(f"header length {header.size} != {_HEADER_LEN}")
        if payload.size != _PAYLOAD_LEN:
            raise ConfigError(
                f"payload length {payload.size} != {_PAYLOAD_LEN}")
        syms = np.concatenate([
            _preamble_symbols(),
            self.header_pm.encode(header),
            self.payload_pm.encode(payload),
            np.zeros(2 * _M, dtype=np.complex64),  # flush the pulse tail
        ])
        return _shape(syms)


class FrameSync64:
    """Burst frame synchronizer (liquid ``framesync64``).

    ``execute(x)`` searches the buffer and returns None (no detection) or a
    dict: header/payload byte arrays, header_valid/payload_valid CRC flags,
    and stats {rxy, tau, dphi, phi, gamma, evm_db}.
    """

    def __init__(self, threshold: float = 0.45, dphi_max: float = 0.02,
                 n_dphi: int = 13):
        self.header_pm = _header_pm()
        self.payload_pm = _payload_pm()
        template = _shape(_preamble_symbols())  # includes the tx ramp-up
        self.detector = QDetector(template, threshold=threshold,
                                  dphi_max=dphi_max, n_dphi=n_dphi)
        self._h = _pulse()
        self._pre = _preamble_symbols()
        self._nsyms = _frame_symbols_len()

    def execute(self, x):
        x = np.asarray(x, dtype=np.complex64).ravel()
        det = self.detector.detect(x)
        self._debug = {"x": x, "det": det, "syms": None}
        if det is None:
            return None
        tau, dphi, phi, gamma = (det["tau"], det["dphi"], det["phi"],
                                 det["gamma"])
        n = np.arange(x.size)
        y = x * np.exp(-1j * (dphi * n + phi)) / max(gamma, 1e-9)
        # sub-sample alignment: advance by frac(tau) via FFT time shift
        i0 = int(np.floor(tau))
        frac = tau - i0
        if frac > 1e-6:
            f = np.fft.fftfreq(y.size)
            y = np.fft.ifft(np.fft.fft(y) * np.exp(2j * np.pi * f * frac))
        # matched filter (full), symbol i of the frame peaks at
        # i0 + (h_len - 1) + i*k in the filtered stream
        z = np.convolve(y, self._h)
        d = self._h.size - 1
        idx = i0 + d + _K * np.arange(self._nsyms)
        if idx[-1] >= z.size:
            return None  # frame truncated by the buffer edge
        syms = z[idx].astype(np.complex64)
        self._debug["syms"] = syms
        # residual carrier: LSQ linear phase fit on the known preamble
        e = syms[:64] * np.conj(self._pre)
        w = np.abs(e)
        ang = np.angle(e)
        i = np.arange(64, dtype=np.float64)
        W = np.sum(w)
        b = (np.sum(w * i * ang) * W - np.sum(w * i) * np.sum(w * ang)) / \
            max(np.sum(w * i * i) * W - np.sum(w * i) ** 2, 1e-12)
        a = (np.sum(w * ang) - b * np.sum(w * i)) / max(W, 1e-12)
        amp = np.sum(w) / max(np.sum(np.abs(self._pre) ** 2), 1e-12)
        k_all = np.arange(self._nsyms, dtype=np.float64)
        syms = syms * np.exp(-1j * (a + b * k_all)) / max(amp, 1e-9)
        # split and decode
        hlen = self.header_pm.get_frame_len()
        plen = self.payload_pm.get_frame_len()
        hdr_syms = syms[64: 64 + hlen]
        pld_syms = syms[64 + hlen: 64 + hlen + plen]
        header, hok = self.header_pm.decode_soft(hdr_syms)
        payload, pok = self.payload_pm.decode_soft(pld_syms)
        # EVM over the preamble (known symbols)
        err = syms[:64] - self._pre
        evm_db = 10.0 * np.log10(
            np.mean(np.abs(err) ** 2) /
            np.mean(np.abs(self._pre) ** 2) + 1e-20)
        return {
            "header": header, "header_valid": bool(hok),
            "payload": payload, "payload_valid": bool(pok),
            "stats": {
                "rxy": det["rxy"], "tau": tau,
                "dphi": dphi + b / _K,  # refined CFO (rad/sample)
                "phi": phi, "gamma": gamma, "evm_db": float(evm_db),
            },
        }

    def debug_export(self, path: str) -> None:
        """Write the last processed buffer/symbols as an Octave script
        (liquid ``framesync64_debug_export``; framesync64_debug_{user,
        ndet,head} autotests: export succeeds whether or not the last
        buffer produced a detection or a decodable header)."""
        dbg = getattr(self, "_debug", None)
        if dbg is None:
            raise ConfigError("no buffer processed yet; nothing to export")

        def _wvec(fh, name, v):
            fh.write("%s = [" % name)
            fh.write(" ".join("(%r+%rj)" % (float(s.real), float(s.imag))
                              for s in np.asarray(v).ravel()))
            fh.write("];\n")

        with open(path, "w") as fh:
            fh.write("%% %s: auto-generated by yagi_tpu FrameSync64\n"
                     % path)
            fh.write("clear all; close all;\n")
            fh.write("num_samples = %d;\n" % dbg["x"].size)
            _wvec(fh, "x", dbg["x"])
            det = dbg["det"]
            fh.write("frame_detected = %d;\n" % (0 if det is None else 1))
            if det is not None:
                fh.write("tau_hat = %r; dphi_hat = %r; gamma_hat = %r;\n"
                         % (float(det["tau"]), float(det["dphi"]),
                            float(det["gamma"])))
            if dbg["syms"] is not None:
                _wvec(fh, "syms", dbg["syms"])
