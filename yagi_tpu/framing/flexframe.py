"""flexframe: flexible burst frame generator + synchronizer.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``flexframesync`` rows in LIQUID_COMPAT.md:1052-1055). Behavioral spec is
liquid-dsp's flexframegen/flexframesync: like frame64 but with a
*runtime-configurable* payload — length, modulation scheme, CRC, and two
FEC levels are chosen per frame and signaled in-band: the synchronizer
first decodes the fixed-format protected header, reads the payload
configuration from its protocol fields, then reconstructs the payload
decoder on the fly.

Wire format (self-consistent to this framework, as with frame64):
64-symbol BPSK p/n preamble; header = [user header bytes | payload_len u16
| mod id | crc id | fec0 id | fec1 id] protected by crc32 + Golay(24,12)
and QPSK-modulated; payload = packetizer(crc,fec0,fec1) + chosen modem;
root-Nyquist pulse shaping at k=2 samples/symbol.

Block-parallel: same block-math receiver as FrameSync64 — QDetector FFT
correlation bank, closed-form carrier/timing correction, one matched
filter convolution, strided symbol gather; plus a pilot-free LSQ phase fit
over the known preamble.
"""

from __future__ import annotations

import numpy as np

from ..design import fir as fir_design
from ..errors import ConfigError
from ..fec.api import FecScheme
from ..fec.crc import CrcScheme
from ..modem.modem import ModulationScheme
from ..sequence.msequence import MSequence
from .qdetector import QDetector
from .qpacketmodem import QPacketModem

__all__ = ["FlexFrameGen", "FlexFrameSync"]

_K = 2          # samples/symbol
_M = 7          # pulse semi-length in symbols
_BETA = 0.3     # excess bandwidth

# in-band id tables: index <-> scheme name (wire protocol)
_MOD_IDS = tuple(s.value for s in ModulationScheme if s.value != "arb")
_CRC_IDS = tuple(s.value for s in CrcScheme)
_FEC_IDS = tuple(s.value for s in FecScheme)
_PROTOCOL_BYTES = 6


def _pulse() -> np.ndarray:
    h = fir_design.fir_design_arkaiser(_K, _M, _BETA, 0.0)
    return (h / np.sqrt(np.sum(h * h) * _K)).astype(np.float32)


def _preamble_symbols() -> np.ndarray:
    ms = MSequence.create_default(7)
    bits = np.array([ms.advance() for _ in range(64)], dtype=np.float32)
    return (1.0 - 2.0 * bits).astype(np.complex64)


def _header_pm(user_len: int) -> QPacketModem:
    return QPacketModem(user_len + _PROTOCOL_BYTES, crc="crc32",
                        fec0="golay2412", fec1="none", mod_scheme="qpsk")


def _shape(symbols: np.ndarray) -> np.ndarray:
    h = _pulse()
    up = np.zeros(symbols.size * _K, dtype=np.complex64)
    up[:: _K] = symbols
    return np.convolve(up, h)[: symbols.size * _K].astype(np.complex64)


class FlexFrameGen:
    """Flexible burst frame generator (liquid ``flexframegen``).

    Payload properties are set per frame via :meth:`assemble` keyword
    arguments (liquid's ``flexframegenprops``): ``mod_scheme``, ``crc``,
    ``fec0``, ``fec1``.
    """

    def __init__(self, header_len: int = 14):
        if header_len < 0:
            raise ConfigError(f"header length ({header_len}) must be >= 0")
        self.header_len = header_len
        self.header_pm = _header_pm(header_len)

    def assemble(self, header, payload, mod_scheme: str = "qpsk",
                 crc: str = "crc32", fec0: str = "none",
                 fec1: str = "none") -> np.ndarray:
        """Build one frame; returns samples [frame_len*k] complex64."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        if header.size != self.header_len:
            raise ConfigError(
                f"header length {header.size} != {self.header_len}")
        if payload.size < 1 or payload.size > 65535:
            raise ConfigError(
                f"payload length ({payload.size}) must be in [1, 65535]")
        try:
            mod_id = _MOD_IDS.index(ModulationScheme.from_str(
                mod_scheme).value)
            crc_id = _CRC_IDS.index(CrcScheme(crc).value)
            fec0_id = _FEC_IDS.index(FecScheme(fec0).value)
            fec1_id = _FEC_IDS.index(FecScheme(fec1).value)
        except ValueError as e:
            raise ConfigError(f"invalid payload property: {e}") from e
        protocol = np.array(
            [payload.size >> 8, payload.size & 0xFF,
             mod_id, crc_id, fec0_id, fec1_id], dtype=np.uint8)
        payload_pm = QPacketModem(payload.size, crc=crc, fec0=fec0,
                                  fec1=fec1, mod_scheme=mod_scheme)
        syms = np.concatenate([
            _preamble_symbols(),
            self.header_pm.encode(np.concatenate([header, protocol])),
            payload_pm.encode(payload),
            np.zeros(2 * _M, dtype=np.complex64),  # flush the pulse tail
        ])
        return _shape(syms)


class FlexFrameSync:
    """Flexible burst frame synchronizer (liquid ``flexframesync``).

    ``execute(x)`` returns None or a dict with header/payload bytes,
    validity flags, the signaled payload properties, and stats.
    """

    def __init__(self, header_len: int = 14, threshold: float = 0.45,
                 dphi_max: float = 0.02, n_dphi: int = 13):
        self.header_len = header_len
        self.header_pm = _header_pm(header_len)
        template = _shape(_preamble_symbols())
        self.detector = QDetector(template, threshold=threshold,
                                  dphi_max=dphi_max, n_dphi=n_dphi)
        self._h = _pulse()
        self._pre = _preamble_symbols()

    @staticmethod
    def _dd_track(syms, modem, chunk: int = 32):
        """Chunk-wise decision-directed carrier phase tracking.

        Replaces liquid's per-symbol payload PLL with block math: per chunk,
        demodulate, re-modulate the decisions, and remove the average phase
        error; the correction accumulates across chunks so a residual CFO is
        tracked through arbitrarily long payloads."""
        out = np.array(syms, dtype=np.complex64)
        phase = 0.0
        for c0 in range(0, out.size, chunk):
            s = out[c0: c0 + chunk] * np.exp(-1j * phase)
            dsyms, _ = modem.demodulate(s.astype(np.complex64))
            ref, _ = modem.modulate(np.asarray(dsyms))
            e = np.sum(s * np.conj(np.asarray(ref)))
            dph = float(np.angle(e))
            phase += dph
            out[c0: c0 + chunk] = s * np.exp(-1j * dph)
        return out

    def _symbols(self, x, det, nsym, known=None):
        """Carrier/timing-corrected symbol stream from the buffer.

        ``known``: optional (indices, symbols) of additional known symbols
        (e.g. the re-encoded header) to extend the linear-phase fit beyond
        the preamble — a longer lever arm pins the residual-CFO slope."""
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
        max_syms = (z.size - 1 - (i0 + d)) // _K + 1
        nsym = min(nsym, max_syms)
        idx = i0 + d + _K * np.arange(nsym)
        syms = z[idx].astype(np.complex64)
        # residual carrier from known symbols (weighted LSQ linear phase)
        p = self._pre
        i = np.arange(p.size, dtype=np.float64)
        ref = p
        if known is not None:
            ki, ks = known
            keep = ki < nsym
            i = np.concatenate([i, ki[keep].astype(np.float64)])
            ref = np.concatenate([p, ks[keep]])
        e = syms[i.astype(np.int64)] * np.conj(ref)
        w = np.abs(e)
        ang = np.unwrap(np.angle(e))
        W = np.sum(w)
        den = max(np.sum(w * i * i) * W - np.sum(w * i) ** 2, 1e-12)
        b = (np.sum(w * i * ang) * W - np.sum(w * i) * np.sum(w * ang)) / den
        a = (np.sum(w * ang) - b * np.sum(w * i)) / max(W, 1e-12)
        amp = W / max(np.sum(np.abs(ref) ** 2), 1e-12)
        kk = np.arange(nsym, dtype=np.float64)
        syms = syms * np.exp(-1j * (a + b * kk)) / max(amp, 1e-9)
        return syms, b

    def execute(self, x):
        x = np.asarray(x, dtype=np.complex64).ravel()
        det = self.detector.detect(x)
        if det is None:
            return None
        hlen = self.header_pm.get_frame_len()
        # first pass: enough symbols for preamble + header
        syms, b = self._symbols(x, det, 64 + hlen)
        if syms.size < 64 + hlen:
            return None
        hdr_syms = syms[64: 64 + hlen]
        header_all, hok = self.header_pm.decode_soft(hdr_syms)
        if not hok:
            return {"header": header_all[: self.header_len],
                    "header_valid": False, "payload": None,
                    "payload_valid": False, "props": None,
                    "stats": self._stats(det, b, syms)}
        user = header_all[: self.header_len]
        proto = header_all[self.header_len:]
        payload_len = (int(proto[0]) << 8) | int(proto[1])
        mod_id, crc_id, fec0_id, fec1_id = (int(proto[2]), int(proto[3]),
                                            int(proto[4]), int(proto[5]))
        if (payload_len < 1 or mod_id >= len(_MOD_IDS)
                or crc_id >= len(_CRC_IDS) or fec0_id >= len(_FEC_IDS)
                or fec1_id >= len(_FEC_IDS)):
            return {"header": user, "header_valid": True, "payload": None,
                    "payload_valid": False, "props": None,
                    "stats": self._stats(det, b, syms)}
        props = {"mod_scheme": _MOD_IDS[mod_id], "crc": _CRC_IDS[crc_id],
                 "fec0": _FEC_IDS[fec0_id], "fec1": _FEC_IDS[fec1_id],
                 "payload_len": payload_len}
        payload_pm = QPacketModem(payload_len, crc=props["crc"],
                                  fec0=props["fec0"], fec1=props["fec1"],
                                  mod_scheme=props["mod_scheme"])
        plen = payload_pm.get_frame_len()
        # second pass: full frame, with the (now-known) header symbols
        # extending the carrier fit past the preamble
        hdr_known = self.header_pm.encode(header_all)
        known = (64 + np.arange(hlen), hdr_known.astype(np.complex64))
        syms, b = self._symbols(x, det, 64 + hlen + plen, known=known)
        if syms.size < 64 + hlen + plen:
            return {"header": user, "header_valid": True, "payload": None,
                    "payload_valid": False, "props": props,
                    "stats": self._stats(det, b, syms)}
        pld_syms = syms[64 + hlen: 64 + hlen + plen]
        # decision-directed phase tracking through the payload (liquid's
        # payload PLL analog); skip for differential schemes, which are
        # insensitive to slow phase rotation by construction
        ms = props["mod_scheme"]
        if not (ms.startswith("dpsk") or ms == "pi4dqpsk"):
            from ..modem.modem import Modem
            pld_syms = self._dd_track(pld_syms, Modem.create(ms))
        payload, pok = payload_pm.decode_soft(pld_syms)
        return {"header": user, "header_valid": True,
                "payload": payload, "payload_valid": bool(pok),
                "props": props, "stats": self._stats(det, b, syms)}

    def _stats(self, det, b, syms):
        err = syms[:64] - self._pre
        evm_db = 10.0 * np.log10(
            np.mean(np.abs(err) ** 2) /
            np.mean(np.abs(self._pre) ** 2) + 1e-20)
        return {"rxy": det["rxy"], "tau": det["tau"],
                "dphi": det["dphi"] + b / _K, "phi": det["phi"],
                "gamma": det["gamma"], "evm_db": float(evm_db)}
