"""msource: multi-signal source generator.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``msource`` rows in LIQUID_COMPAT.md). Behavioral spec is liquid-dsp's
msource: a container of independent signal sources — tones, band-limited
noise, and modulated symbol streams — each placed at its own center
frequency with its own gain, summed into one output stream. Used to build
test spectra for channelizer / receiver validation.

Block-parallel: every source produces a block at baseband (SymStreamR already
batches; noise is one filtered jax.random block; a tone is one vectorized
cexp), and the frequency shift is a vectorized mixer with an exact
per-source phase carry, so repeated ``write_samples`` calls are
block-size invariant like every other streaming op in the framework.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError
from ..design.fir import fir_design_kaiser
from .symstream import SymStreamR

__all__ = ["MSource"]


class _Source:
    def __init__(self, fc: float, gain_db: float):
        if not -0.5 <= fc <= 0.5:
            raise ConfigError(f"center frequency fc ({fc}) not in [-0.5,0.5]")
        self.fc = fc
        self.gain = 10.0 ** (gain_db / 20.0)
        self.enabled = True
        self._phase = 0.0

    def _mix(self, base: np.ndarray) -> np.ndarray:
        n = np.arange(base.size)
        out = base * np.exp(1j * (2 * np.pi * self.fc * n + self._phase))
        self._phase = float(
            (self._phase + 2 * np.pi * self.fc * base.size) % (2 * np.pi))
        return (self.gain * out).astype(np.complex64)


class _Tone(_Source):
    def baseband(self, n: int, rng) -> np.ndarray:
        return np.ones(n, dtype=np.complex64)


class _Noise(_Source):
    def __init__(self, fc: float, bw: float, gain_db: float):
        super().__init__(fc, gain_db)
        if not 0.0 < bw <= 1.0:
            raise ConfigError(f"noise bandwidth ({bw}) not in (0,1]")
        self.bw = bw
        if bw < 0.995:
            h_len = 4 * int(np.ceil(2.0 / bw)) * 2 + 1
            self._h = fir_design_kaiser(h_len, bw / 2, 60.0, 0.0)
            self._h = self._h / np.sqrt(np.sum(self._h ** 2))
            self._tail = np.zeros(self._h.size - 1, dtype=np.complex64)
        else:
            self._h = None

    def baseband(self, n: int, rng) -> np.ndarray:
        w = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
            np.complex64) / np.sqrt(2)
        if self._h is None:
            return w
        full = np.convolve(np.concatenate([self._tail, w]), self._h)
        out = full[self._tail.size: self._tail.size + n]
        self._tail = np.concatenate([self._tail, w])[-(self._h.size - 1):]
        return out.astype(np.complex64)


class _Chirp(_Source):
    """Linear FM sweep across ``bw`` over ``duration`` samples
    (liquid msource_crcf_add_chirp; msourcecf_chirp autotest)."""

    def __init__(self, fc: float, bw: float, gain_db: float,
                 duration: float, negate: bool, repeat: bool):
        super().__init__(fc, gain_db)
        if not 0.0 < bw <= 1.0:
            raise ConfigError(f"chirp bandwidth ({bw}) not in (0,1]")
        if duration < 1:
            raise ConfigError(f"chirp duration ({duration}) must be >= 1")
        self.bw = float(bw)
        self.duration = float(duration)
        self.negate = bool(negate)
        self.repeat = bool(repeat)
        self._t = 0.0

    def baseband(self, n: int, rng) -> np.ndarray:
        t = self._t + np.arange(n, dtype=np.float64)
        tt = np.mod(t, self.duration) if self.repeat \
            else np.minimum(t, self.duration)
        # instantaneous freq sweeps -bw/2 -> +bw/2; phase is its integral
        sgn = -1.0 if self.negate else 1.0
        phase = 2 * np.pi * sgn * self.bw * (tt * tt / (2 * self.duration)
                                             - tt / 2)
        self._t += n
        return np.exp(1j * phase).astype(np.complex64)


class _ModemSrc(_Source):
    def __init__(self, fc: float, bw: float, gain_db: float, scheme: str,
                 m: int, beta: float):
        super().__init__(fc, gain_db)
        self.stream = SymStreamR(bw=bw, m=m, beta=beta, scheme=scheme)

    def baseband(self, n: int, rng) -> np.ndarray:
        return np.asarray(self.stream.write_samples(n), dtype=np.complex64)


class MSource:
    """Multi-source signal generator (liquid ``msource``)."""

    def __init__(self, seed: int = 0):
        self._sources: dict[int, _Source] = {}
        self._next_id = 0
        self._rng = np.random.default_rng(seed)

    def _add(self, src: _Source) -> int:
        sid = self._next_id
        self._sources[sid] = src
        self._next_id += 1
        return sid

    def add_tone(self, fc: float, gain_db: float = 0.0) -> int:
        """Complex tone at fc (liquid ``msource_add_tone``)."""
        return self._add(_Tone(fc, gain_db))

    def add_noise(self, fc: float, bw: float, gain_db: float = 0.0) -> int:
        """Band-limited Gaussian noise (liquid ``msource_add_noise``)."""
        return self._add(_Noise(fc, bw, gain_db))

    def add_chirp(self, fc: float, bw: float, gain_db: float = 0.0,
                  duration: float = 1000.0, negate: bool = False,
                  repeat: bool = True) -> int:
        """Linear FM chirp sweeping bw over duration samples
        (liquid ``msource_add_chirp``)."""
        return self._add(_Chirp(fc, bw, gain_db, duration, negate, repeat))

    def add_modem(self, scheme: str, fc: float, bw: float,
                  gain_db: float = 0.0, m: int = 7,
                  beta: float = 0.3) -> int:
        """Modulated symbol stream (liquid ``msource_add_modem``)."""
        return self._add(_ModemSrc(fc, bw, gain_db, scheme, m, beta))

    def remove(self, sid: int) -> None:
        if sid not in self._sources:
            raise ConfigError(f"unknown source id {sid}")
        del self._sources[sid]

    def enable(self, sid: int) -> None:
        self._sources[sid].enabled = True

    def disable(self, sid: int) -> None:
        self._sources[sid].enabled = False

    def get_num_sources(self) -> int:
        return len(self._sources)

    def write_samples(self, n: int) -> np.ndarray:
        """Sum of all enabled sources, n samples (block-size invariant)."""
        out = np.zeros(n, dtype=np.complex64)
        for src in self._sources.values():
            base = src.baseband(n, self._rng)
            if src.enabled:
                out += src._mix(base)
            else:
                # keep phase/stream state advancing while muted
                src._mix(base)
        return out
