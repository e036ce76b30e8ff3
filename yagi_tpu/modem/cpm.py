"""Continuous-phase modems: GMSK and CPFSK.

Fills reference gaps: yagi ports neither ``gmskmod``/``gmskdem`` nor
``cpfskmod``/``cpfskdem`` (no src/modem/gmsk*.rs or cpfsk*.rs exist;
LIQUID_COMPAT.md lists the liquid autotests unported). Behavioral spec is
liquid-dsp: a symbol stream drives a frequency pulse (Gaussian for GMSK;
square / raised-cosine full / raised-cosine partial / Gaussian for CPFSK
with modulation index h); the transmitted signal is ``exp(j*theta)`` where
theta integrates the pulse-shaped instantaneous frequency. Demodulation is
non-coherent: frequency discrimination (``arg(conj(y')y)``) followed by the
receive matched filter and symbol-rate decisions.

Block-parallel math: the per-sample interpolate→integrate loop of the
reference becomes one XLA convolution (zero-stuffed symbols * pulse) plus
one cumulative sum for the phase; demodulation is one conjugate-product,
one convolution, and a strided gather — no per-sample Python. Streaming
state (phase accumulator, filter tails) is carried in the pytree so block
splits are exactly equivalent to contiguous processing.

The Gaussian transmit/receive pulse designs are the reference's
``fir_design_gmsktx``/``gmskrx`` (design/gmsk.rs:20,66).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .._src import struct
from ..design import fir as fir_design
from ..errors import ConfigError

__all__ = ["GmskMod", "GmskDem", "CpfskMod", "CpfskDem", "CpfskFilterType"]


def _stream_conv(window, up, h):
    """Streaming valid convolution: prepend carried window, convolve.

    window [..., Lh-1] history, up [..., N] new input, h [Lh] taps.
    Returns (y [..., N], new_window [..., Lh-1]).
    """
    seq = jnp.concatenate([window, up], axis=-1)
    # correlation with flipped taps == convolution, steady-state outputs only
    hh = jnp.asarray(h[::-1].copy(), dtype=seq.dtype)
    n = up.shape[-1]
    lh = h.shape[0]
    idx = jnp.arange(n)[:, None] + jnp.arange(lh)[None, :]
    y = jnp.einsum("...nk,k->...n", seq[..., idx], hh)
    return y, seq[..., -(lh - 1):]


@struct.pytree
class GmskMod:
    """GMSK modulator (liquid ``gmskmod``): k samples/symbol, m symbol
    delay, bandwidth-time product bt.

    Phase advances by +/- pi/2 per bit (MSK), shaped by the Gaussian pulse.
    """

    k: int = struct.static_field()
    m: int = struct.static_field()
    bt: float = struct.static_field()
    h: jnp.ndarray = struct.field()       # tx frequency pulse [2km+1]
    theta: jnp.ndarray = struct.field()   # carried phase
    window: jnp.ndarray = struct.field()  # upsampled-symbol history [2km]

    @classmethod
    def create(cls, k: int = 2, m: int = 3, bt: float = 0.3,
               batch_shape: tuple = ()) -> "GmskMod":
        if k < 2:
            raise ConfigError(f"samples/symbol ({k}) must be >= 2")
        if m < 1:
            raise ConfigError(f"filter delay ({m}) must be >= 1")
        if not 0.0 < bt < 1.0:
            raise ConfigError(f"bandwidth-time product ({bt}) must be in (0,1)")
        h = fir_design.fir_design_gmsktx(k, m, bt, 0.0).astype(np.float32)
        lh = h.shape[0]
        return cls(
            k=k, m=m, bt=float(bt),
            h=jnp.asarray(h),
            theta=jnp.zeros(batch_shape, dtype=jnp.float32),
            window=jnp.zeros(batch_shape + (lh - 1,), dtype=jnp.float32),
        )

    def reset(self) -> "GmskMod":
        return self.replace(theta=jnp.zeros_like(self.theta),
                            window=jnp.zeros_like(self.window))

    def modulate(self, bits) -> tuple[jnp.ndarray, "GmskMod"]:
        """bits [..., S] in {0,1} -> samples [..., S*k] complex64.

        Output symbol j is centered ``m`` symbols after input symbol j
        (the transmit pulse group delay), as in liquid.
        """
        bits = jnp.asarray(bits)
        v = 2.0 * bits.astype(jnp.float32) - 1.0  # NRZ
        up = jnp.zeros(v.shape[:-1] + (v.shape[-1] * self.k,), jnp.float32)
        up = up.at[..., :: self.k].set(v)
        f, new_win = _stream_conv(self.window, up, np.asarray(self.h))
        # gmsktx integrates to pi*k/2 per unit symbol; /k makes it pi/2
        dtheta = f / jnp.float32(self.k)
        theta = self.theta[..., None] + jnp.cumsum(dtheta, axis=-1)
        y = jnp.exp(1j * theta).astype(jnp.complex64)
        return y, self.replace(theta=theta[..., -1], window=new_win)

    __call__ = modulate


@struct.pytree
class GmskDem:
    """GMSK demodulator (liquid ``gmskdem``): frequency discriminator +
    Gaussian receive matched filter + sign decision at symbol rate.

    Total mod->dem latency is ``2m`` symbols (tx pulse m + rx filter m).
    """

    k: int = struct.static_field()
    m: int = struct.static_field()
    bt: float = struct.static_field()
    h: jnp.ndarray = struct.field()        # rx filter [2km+1]
    prev: jnp.ndarray = struct.field()     # last rx sample (discriminator)
    window: jnp.ndarray = struct.field()   # freq-signal history [2km]

    @classmethod
    def create(cls, k: int = 2, m: int = 3, bt: float = 0.3,
               batch_shape: tuple = ()) -> "GmskDem":
        if k < 2:
            raise ConfigError(f"samples/symbol ({k}) must be >= 2")
        if m < 1:
            raise ConfigError(f"filter delay ({m}) must be >= 1")
        if not 0.0 < bt < 1.0:
            raise ConfigError(f"bandwidth-time product ({bt}) must be in (0,1)")
        h = fir_design.fir_design_gmskrx(k, m, bt, 0.0).astype(np.float32)
        lh = h.shape[0]
        return cls(
            k=k, m=m, bt=float(bt),
            h=jnp.asarray(h),
            prev=jnp.ones(batch_shape, dtype=jnp.complex64),
            window=jnp.zeros(batch_shape + (lh - 1,), dtype=jnp.float32),
        )

    def reset(self) -> "GmskDem":
        return self.replace(prev=jnp.ones_like(self.prev),
                            window=jnp.zeros_like(self.window))

    def demodulate(self, y) -> tuple[jnp.ndarray, "GmskDem"]:
        """samples [..., S*k] -> bits [..., S] (delayed by 2m symbols)."""
        y = jnp.asarray(y)
        shifted = jnp.concatenate([self.prev[..., None], y[..., :-1]], axis=-1)
        f = jnp.angle(y * jnp.conj(shifted))  # instantaneous frequency
        z, new_win = _stream_conv(self.window, f, np.asarray(self.h))
        d = z[..., :: self.k]  # decision-rate samples
        bits = (d > 0).astype(jnp.uint8)
        return bits, self.replace(prev=y[..., -1], window=new_win)

    __call__ = demodulate


# ---------------------------------------------------------------- CPFSK

class CpfskFilterType:
    """Frequency-pulse shapes (liquid LIQUID_CPFSK_*)."""
    SQUARE = "square"
    RCOS_FULL = "rcos-full"
    RCOS_PARTIAL = "rcos-partial"
    GMSK = "gmsk"

    ALL = (SQUARE, RCOS_FULL, RCOS_PARTIAL, GMSK)


def _cpfsk_pulse(ftype: str, k: int, m: int, beta: float) -> np.ndarray:
    """Frequency pulse, normalized so its sum is ``k`` (unit phase-rate
    integral after the modulator's /k): a unit-level symbol advances the
    phase by exactly ``pi*h_index`` (applied separately)."""
    if ftype == CpfskFilterType.SQUARE:
        h = np.ones(k, dtype=np.float64)
    elif ftype == CpfskFilterType.RCOS_FULL:
        n = np.arange(k, dtype=np.float64)
        h = 1.0 - np.cos(2.0 * np.pi * (n + 0.5) / k)
    elif ftype == CpfskFilterType.RCOS_PARTIAL:
        # partial response: raised cosine spanning 2 symbols (L=2 CPM)
        n = np.arange(2 * k, dtype=np.float64)
        h = 1.0 - np.cos(2.0 * np.pi * (n + 0.5) / (2 * k))
    elif ftype == CpfskFilterType.GMSK:
        h = fir_design.fir_design_gmsktx(k, m, beta, 0.0).astype(np.float64)
    else:
        raise ConfigError(f"unknown cpfsk filter type '{ftype}'")
    return (h * (k / np.sum(h))).astype(np.float32)


@struct.pytree
class CpfskMod:
    """CPFSK modulator (liquid ``cpfskmod``): bps bits/symbol, modulation
    index h_index, k samples/symbol, delay m, pulse beta, filter type."""

    bps: int = struct.static_field()
    h_index: float = struct.static_field()
    k: int = struct.static_field()
    m: int = struct.static_field()
    beta: float = struct.static_field()
    ftype: str = struct.static_field()
    p: jnp.ndarray = struct.field()       # frequency pulse
    theta: jnp.ndarray = struct.field()
    window: jnp.ndarray = struct.field()

    @classmethod
    def create(cls, bps: int = 1, h_index: float = 0.5, k: int = 4,
               m: int = 3, beta: float = 0.35,
               ftype: str = CpfskFilterType.SQUARE,
               batch_shape: tuple = ()) -> "CpfskMod":
        if bps < 1 or bps > 8:
            raise ConfigError(f"bits/symbol ({bps}) must be in [1,8]")
        if h_index <= 0.0:
            raise ConfigError(f"modulation index ({h_index}) must be > 0")
        if k < 2:
            raise ConfigError(f"samples/symbol ({k}) must be >= 2")
        if m < 1:
            raise ConfigError(f"filter delay ({m}) must be >= 1")
        if ftype not in CpfskFilterType.ALL:
            raise ConfigError(f"unknown cpfsk filter type '{ftype}'")
        p = _cpfsk_pulse(ftype, k, m, beta)
        return cls(
            bps=bps, h_index=float(h_index), k=k, m=m, beta=float(beta),
            ftype=ftype,
            p=jnp.asarray(p),
            theta=jnp.zeros(batch_shape, dtype=jnp.float32),
            window=jnp.zeros(batch_shape + (p.shape[0] - 1,),
                             dtype=jnp.float32),
        )

    @property
    def m_size(self) -> int:
        return 1 << self.bps

    def reset(self) -> "CpfskMod":
        return self.replace(theta=jnp.zeros_like(self.theta),
                            window=jnp.zeros_like(self.window))

    def modulate(self, symbols) -> tuple[jnp.ndarray, "CpfskMod"]:
        """symbols [..., S] in [0, 2^bps) -> samples [..., S*k]."""
        s = jnp.asarray(symbols)
        # NRZ level: 2s - (M-1), phase per symbol = pi * h_index * level
        v = (2.0 * s.astype(jnp.float32) - (self.m_size - 1))
        up = jnp.zeros(v.shape[:-1] + (v.shape[-1] * self.k,), jnp.float32)
        up = up.at[..., :: self.k].set(v)
        f, new_win = _stream_conv(self.window, up, np.asarray(self.p))
        dtheta = f * jnp.float32(np.pi * self.h_index / self.k)
        theta = self.theta[..., None] + jnp.cumsum(dtheta, axis=-1)
        y = jnp.exp(1j * theta).astype(jnp.complex64)
        return y, self.replace(theta=theta[..., -1], window=new_win)

    __call__ = modulate


@struct.pytree
class CpfskDem:
    """CPFSK demodulator: discriminator + pulse matched filter + nearest-
    level decision. Delay (in symbols) is ``delay_syms``."""

    bps: int = struct.static_field()
    h_index: float = struct.static_field()
    k: int = struct.static_field()
    m: int = struct.static_field()
    beta: float = struct.static_field()
    ftype: str = struct.static_field()
    delay_syms: int = struct.static_field()
    offset: int = struct.static_field()   # decision sample offset in [0,k)
    gain: float = struct.static_field()   # per-unit-level decision gain
    p: jnp.ndarray = struct.field()       # rx matched filter (pulse/k)
    prev: jnp.ndarray = struct.field()
    window: jnp.ndarray = struct.field()

    @classmethod
    def create(cls, bps: int = 1, h_index: float = 0.5, k: int = 4,
               m: int = 3, beta: float = 0.35,
               ftype: str = CpfskFilterType.SQUARE,
               batch_shape: tuple = ()) -> "CpfskDem":
        if bps < 1 or bps > 8:
            raise ConfigError(f"bits/symbol ({bps}) must be in [1,8]")
        if h_index <= 0.0:
            raise ConfigError(f"modulation index ({h_index}) must be > 0")
        if ftype not in CpfskFilterType.ALL:
            raise ConfigError(f"unknown cpfsk filter type '{ftype}'")
        p = _cpfsk_pulse(ftype, k, m, beta)
        # decision calibration: single unit-level symbol through tx pulse
        # (as instantaneous frequency) then the rx matched filter; the
        # decision instant/gain is the response peak.
        f_tx = p.astype(np.float64) * (np.pi * h_index / k)
        resp = np.convolve(f_tx, p.astype(np.float64) / k)
        # decide exactly at the response peak: for full-response pulses the
        # adjacent-symbol ISI is zero there (support is < 2 symbols wide)
        peak = int(np.argmax(resp))
        delay_syms = peak // k
        offset = peak % k
        gain = float(resp[peak])
        return cls(
            bps=bps, h_index=float(h_index), k=k, m=m, beta=float(beta),
            ftype=ftype, delay_syms=delay_syms, offset=offset, gain=gain,
            p=jnp.asarray(p / np.float32(k)),
            prev=jnp.ones(batch_shape, dtype=jnp.complex64),
            window=jnp.zeros(batch_shape + (p.shape[0] - 1,),
                             dtype=jnp.float32),
        )

    @property
    def m_size(self) -> int:
        return 1 << self.bps

    def reset(self) -> "CpfskDem":
        return self.replace(prev=jnp.ones_like(self.prev),
                            window=jnp.zeros_like(self.window))

    def demodulate(self, y) -> tuple[jnp.ndarray, "CpfskDem"]:
        """samples [..., S*k] -> symbols [..., S] (delayed delay_syms)."""
        y = jnp.asarray(y)
        shifted = jnp.concatenate([self.prev[..., None], y[..., :-1]],
                                  axis=-1)
        f = jnp.angle(y * jnp.conj(shifted))
        z, new_win = _stream_conv(self.window, f, np.asarray(self.p))
        # estimated NRZ level, sampled at the calibrated peak offset
        d = z[..., self.offset:: self.k] / jnp.float32(self.gain)
        sym = jnp.round(0.5 * (d + (self.m_size - 1))).astype(jnp.int32)
        sym = jnp.clip(sym, 0, self.m_size - 1)
        return sym, self.replace(prev=y[..., -1], window=new_win)

    __call__ = demodulate
