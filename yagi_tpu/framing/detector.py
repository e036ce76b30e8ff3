"""Detector: streaming preamble detector (liquid ``detector_cccf``).

Behavioral spec: liquid-dsp's ``detector_cccf`` (LIQUID_COMPAT.md "detector"
rows — never ported by the reference): feed samples continuously; when the
normalized cross-correlation against a known complex template crosses the
threshold, report a detection with timing offset ``tau`` (sub-sample),
carrier frequency offset ``dphi`` and channel gain ``gamma``.

Block-parallel: the streaming interface wraps the same batched FFT
correlation-surface engine as :class:`~yagi_tpu.framing.qdetector.QDetector`
(one [n_dphi, Nfft] product per block); the only sequential state is the
(L-1)-sample overlap tail carried between blocks so a template straddling a
block boundary is still found. Multiple detections per block are extracted
greedily with a ±L/2 debounce, mirroring detector_cccf's one-shot reporting.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..errors import ConfigError
from .qdetector import QDetector, _quad_peak, _xcorr_surface

__all__ = ["Detector"]


class Detector:
    """Streaming known-template detector with tau/dphi/gamma estimates."""

    def __init__(self, sequence, threshold: float = 0.5,
                 dphi_max: float = 0.02, n_dphi: int = 9,
                 max_detections_per_block: int = 4):
        # reuse QDetector's validated hypothesis bank
        self._q = QDetector(sequence, threshold=threshold,
                            dphi_max=dphi_max, n_dphi=n_dphi)
        self.L = self._q.L
        self.threshold = float(threshold)
        self.max_det = int(max_detections_per_block)
        if self.max_det < 1:
            raise ConfigError("max_detections_per_block must be >= 1")
        self.reset()

    def reset(self) -> None:
        self._tail = np.zeros(0, dtype=np.complex64)
        self._offset = 0  # absolute sample index of _tail[0]

    def execute(self, block):
        """Process the next block; returns a list of detection dicts, each
        with keys ``tau`` (absolute sample offset of template start, sub-
        sample), ``dphi``, ``phi``, ``gamma``, ``rxy``."""
        block = np.asarray(block, dtype=np.complex64).ravel()
        x = np.concatenate([self._tail, block])
        out = []
        if x.size >= self.L:
            q = self._q
            nfft = 1 << int(np.ceil(np.log2(x.size + q.L)))
            R = np.asarray(_xcorr_surface(jnp.asarray(x),
                                          jnp.asarray(q._bank), nfft))
            mag = np.abs(R)
            n_lags = x.size - q.L + 1
            mag_v = mag[:, :n_lags].copy()
            # normalized correlation per lag (local received energy)
            e_loc = np.convolve(np.abs(x) ** 2, np.ones(q.L), mode="valid")
            norm = np.sqrt(q._e_s * np.maximum(e_loc, 1e-20))
            # detect on the NORMALIZED surface — the same quantity the
            # threshold tests — so a weak burst in a low-energy region is
            # not shadowed by a strong sub-threshold interferer
            surf = mag_v / norm[None, :]
            for _ in range(self.max_det):
                h, lag = np.unravel_index(np.argmax(surf), surf.shape)
                rxy = surf[h, lag]
                if rxy < self.threshold:
                    break
                peak = mag_v[h, lag]
                ym1 = mag[h, lag - 1] if lag > 0 else peak
                # mag[h, lag+1] exists up to nfft (> n_lags): use it rather
                # than clamping at the lag range, which biases tau by +0.5
                # for detections ending exactly at a block boundary
                yp1 = mag[h, lag + 1] if lag + 1 < mag.shape[1] else peak
                dtau = float(_quad_peak(ym1, peak, yp1))
                if len(q.dphis) > 1:
                    hm1 = mag[h - 1, lag] if h > 0 else peak
                    hp1 = mag[h + 1, lag] if h + 1 < len(q.dphis) else peak
                    dh = float(_quad_peak(hm1, peak, hp1))
                    dphi = float(q.dphis[h] + dh * (q.dphis[1] - q.dphis[0]))
                else:
                    dphi = 0.0
                out.append({
                    "tau": self._offset + lag + dtau,
                    "dphi": dphi,
                    "phi": float(np.angle(R[h, lag])),
                    "gamma": float(peak / q._e_s),
                    "rxy": float(rxy),
                })
                # debounce: suppress the neighborhood of this peak
                lo = max(0, lag - q.L // 2)
                hi = min(n_lags, lag + q.L // 2 + 1)
                mag_v[:, lo:hi] = 0.0
                surf[:, lo:hi] = 0.0
        # carry the last L-1 samples so a straddling template is found
        keep = min(self.L - 1, x.size)
        self._offset += x.size - keep
        self._tail = x[x.size - keep:]
        out.sort(key=lambda d: d["tau"])
        return out
