"""qdsync: detector + symbol synchronizer for burst streams.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``qdsync_cccf`` rows in LIQUID_COMPAT.md:1154-1162). Behavioral spec is
liquid-dsp's qdsync_cccf: given a known preamble symbol sequence and a
root-Nyquist pulse (k samples/symbol, delay m, excess bandwidth beta),
detect the preamble in a raw sample stream, recover timing (sub-sample),
carrier frequency/phase and gain, and emit synchronized symbols at 1
sample/symbol from the preamble start onward.

Block-parallel: detection is the QDetector FFT correlation bank; the corrections
are closed-form whole-buffer vector ops (rotate, FFT fractional shift, one
matched-filter convolution, strided gather) — burst = block, so block math
replaces liquid's per-sample mixer/symsync feedback loops.
"""

from __future__ import annotations

import numpy as np

from ..design import fir as fir_design
from ..errors import ConfigError
from .qdetector import QDetector

__all__ = ["QDSync"]


class QDSync:
    """Burst symbol synchronizer keyed on a known preamble.

    Parameters mirror ``qdsync_cccf_create(seq, k, m, beta)``:
    ``preamble`` — known symbols; ``k`` — samples/symbol; ``m`` — filter
    semi-length in symbols; ``beta`` — excess bandwidth.
    """

    def __init__(self, preamble, k: int = 2, m: int = 7, beta: float = 0.3,
                 threshold: float = 0.5, dphi_max: float = 0.02,
                 n_dphi: int = 13):
        preamble = np.asarray(preamble, dtype=np.complex64).ravel()
        if preamble.size < 8:
            raise ConfigError(
                f"preamble length ({preamble.size}) must be >= 8")
        if k < 2:
            raise ConfigError(f"samples/symbol ({k}) must be >= 2")
        if m < 1:
            raise ConfigError(f"filter delay ({m}) must be >= 1")
        if not 0.0 < beta <= 1.0:
            raise ConfigError(f"excess bandwidth ({beta}) must be in (0,1]")
        self.preamble = preamble
        self.k = k
        self.m = m
        self.beta = float(beta)
        h = fir_design.fir_design_arkaiser(k, m, beta, 0.0)
        self._h = (h / np.sqrt(np.sum(h * h) * k)).astype(np.float32)
        # detection template: pulse-shaped preamble (with tx ramp-up)
        up = np.zeros(preamble.size * k, dtype=np.complex64)
        up[::k] = preamble
        template = np.convolve(up, self._h)[: preamble.size * k]
        self.detector = QDetector(template.astype(np.complex64),
                                  threshold=threshold, dphi_max=dphi_max,
                                  n_dphi=n_dphi)

    def set_buf_len(self, n: int) -> None:
        """Cap the number of symbols extracted per detection
        (liquid ``qdsync_cccf_set_buf_len``; qdsync_set_buf_len autotest).

        The batch analog of liquid's streaming output-buffer length: a
        default bound applied when ``execute`` is called without
        ``n_symbols``.
        """
        if n < self.preamble.size:
            raise ConfigError(
                f"buffer length ({n}) must be >= preamble length "
                f"({self.preamble.size})")
        self._buf_len = int(n)

    def get_buf_len(self) -> int:
        return getattr(self, "_buf_len", 0) or 0

    def execute(self, x, n_symbols: int | None = None):
        """Search buffer ``x``; return None or ``(symbols, stats)``.

        ``symbols`` starts at the first preamble symbol; ``n_symbols``
        bounds how many are extracted (default: the ``set_buf_len`` cap
        if set, else as many as the buffer holds). ``stats``: rxy, tau,
        dphi, phi, gamma, evm_db (preamble).
        """
        if n_symbols is None and getattr(self, "_buf_len", 0):
            n_symbols = self._buf_len
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
        if frac > 1e-6:  # sub-sample advance via FFT phase ramp
            f = np.fft.fftfreq(y.size)
            y = np.fft.ifft(np.fft.fft(y) * np.exp(2j * np.pi * f * frac))
        z = np.convolve(y, self._h)
        d = self._h.size - 1
        max_syms = (z.size - 1 - (i0 + d)) // self.k + 1
        nsym = max_syms if n_symbols is None else min(n_symbols, max_syms)
        if nsym < self.preamble.size:
            return None  # buffer too short past the detection point
        idx = i0 + d + self.k * np.arange(nsym)
        syms = z[idx].astype(np.complex64)
        # residual carrier: weighted LSQ linear-phase fit on the preamble
        p = self.preamble
        e = syms[: p.size] * np.conj(p)
        w = np.abs(e)
        ang = np.angle(e)
        i = np.arange(p.size, dtype=np.float64)
        W = np.sum(w)
        det_denom = max(np.sum(w * i * i) * W - np.sum(w * i) ** 2, 1e-12)
        b = (np.sum(w * i * ang) * W - np.sum(w * i) * np.sum(w * ang)) \
            / det_denom
        a = (np.sum(w * ang) - b * np.sum(w * i)) / max(W, 1e-12)
        amp = W / max(np.sum(np.abs(p) ** 2), 1e-12)
        kk = np.arange(nsym, dtype=np.float64)
        syms = syms * np.exp(-1j * (a + b * kk)) / max(amp, 1e-9)
        err = syms[: p.size] - p
        evm_db = 10.0 * np.log10(
            np.mean(np.abs(err) ** 2) / np.mean(np.abs(p) ** 2) + 1e-20)
        stats = {"rxy": det["rxy"], "tau": tau,
                 "dphi": dphi + b / self.k, "phi": phi, "gamma": gamma,
                 "evm_db": float(evm_db)}
        return syms, stats
