"""gmskframe: GMSK-modulated burst frame generator + synchronizer.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``gmskframesync_*`` rows in LIQUID_COMPAT.md:1079-1092). Behavioral spec is
liquid-dsp's gmskframegen/gmskframesync: a constant-envelope burst — p/n
preamble, protected header carrying the payload configuration (length, CRC,
FEC levels), protected payload — GMSK-modulated at k samples/symbol with
bandwidth-time product bt; the synchronizer detects the burst at unknown
delay/carrier/gain, recovers timing and CFO, and decodes header and
payload with soft decisions.

Block-parallel: the GMSK preamble waveform is a deterministic complex template,
so detection reuses the QDetector FFT correlation bank; demodulation is
the block GmskDem (discriminator + receive matched filter — one conjugate
product + one convolution); the frequency discriminator is inherently
insensitive to carrier phase and channel gain, so only timing and CFO need
correction. Soft bits for the FEC decoder come from the matched-filter
amplitudes, scaled by the per-bit decision gain.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError
from ..fec import Packetizer
from ..fec._bits import pack_bits, unpack_bits
from ..fec.api import FecScheme
from ..fec.crc import CrcScheme
from ..modem.cpm import GmskMod, GmskDem
from ..sequence.msequence import MSequence
from .qdetector import QDetector

__all__ = ["GmskFrameGen", "GmskFrameSync"]

_PRE_LEN = 64       # preamble bits
_CRC_IDS = tuple(s.value for s in CrcScheme)
_FEC_IDS = tuple(s.value for s in FecScheme)
_PROTOCOL_BYTES = 5  # payload_len u16 + crc id + fec0 id + fec1 id


def _preamble_bits() -> np.ndarray:
    ms = MSequence.create_default(7)
    return np.array([ms.advance() for _ in range(_PRE_LEN)], dtype=np.uint8)


def _header_pk(user_len: int) -> Packetizer:
    return Packetizer(user_len + _PROTOCOL_BYTES, crc="crc32",
                      fec0="golay2412", fec1="none")


def _bits_of(pk: Packetizer, payload: np.ndarray) -> np.ndarray:
    return unpack_bits(pk.encode(payload))


class GmskFrameGen:
    """GMSK burst frame generator (liquid ``gmskframegen``)."""

    def __init__(self, k: int = 2, m: int = 3, bt: float = 0.5,
                 header_len: int = 8):
        if header_len < 0:
            raise ConfigError(f"header length ({header_len}) must be >= 0")
        self.k, self.m, self.bt = k, m, float(bt)
        self.header_len = header_len
        self.header_pk = _header_pk(header_len)
        # constructing the modulator validates k/m/bt
        GmskMod.create(k=k, m=m, bt=bt)

    def assemble(self, header, payload, crc: str = "crc32",
                 fec0: str = "none", fec1: str = "none") -> np.ndarray:
        """Build one frame; returns samples complex64."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        if header.size != self.header_len:
            raise ConfigError(
                f"header length {header.size} != {self.header_len}")
        if payload.size < 1 or payload.size > 65535:
            raise ConfigError(
                f"payload length ({payload.size}) must be in [1, 65535]")
        try:
            crc_id = _CRC_IDS.index(CrcScheme(crc).value)
            fec0_id = _FEC_IDS.index(FecScheme(fec0).value)
            fec1_id = _FEC_IDS.index(FecScheme(fec1).value)
        except ValueError as e:
            raise ConfigError(f"invalid payload property: {e}") from e
        protocol = np.array([payload.size >> 8, payload.size & 0xFF,
                             crc_id, fec0_id, fec1_id], dtype=np.uint8)
        payload_pk = Packetizer(payload.size, crc=crc, fec0=fec0, fec1=fec1)
        bits = np.concatenate([
            _preamble_bits(),
            _bits_of(self.header_pk, np.concatenate([header, protocol])),
            _bits_of(payload_pk, payload),
            np.zeros(4 * self.m, dtype=np.uint8),  # flush tx+rx filters
        ])
        mod = GmskMod.create(k=self.k, m=self.m, bt=self.bt)
        y, _ = mod.modulate(bits)
        return np.asarray(y, dtype=np.complex64)


class GmskFrameSync:
    """GMSK burst frame synchronizer (liquid ``gmskframesync``)."""

    def __init__(self, k: int = 2, m: int = 3, bt: float = 0.5,
                 header_len: int = 8, threshold: float = 0.5,
                 dphi_max: float = 0.02, n_dphi: int = 13):
        self.k, self.m, self.bt = k, m, float(bt)
        self.header_len = header_len
        self.header_pk = _header_pk(header_len)
        mod = GmskMod.create(k=k, m=m, bt=bt)
        template, _ = mod.modulate(_preamble_bits())
        self.detector = QDetector(np.asarray(template), threshold=threshold,
                                  dphi_max=dphi_max, n_dphi=n_dphi)
        self._rx_h = np.asarray(GmskDem.create(k=k, m=m, bt=bt).h)

    def execute(self, x):
        """Search buffer ``x``; None or dict with header/payload/props/stats."""
        x = np.asarray(x, dtype=np.complex64).ravel()
        det = self.detector.detect(x)
        if det is None:
            return None
        tau, dphi = det["tau"], det["dphi"]
        n = np.arange(x.size)
        y = x * np.exp(-1j * dphi * n)  # CFO removal (phase/gain moot)
        i0 = int(np.floor(tau))
        frac = tau - i0
        if frac > 1e-6:
            f = np.fft.fftfreq(y.size)
            y = np.fft.ifft(np.fft.fft(y) * np.exp(2j * np.pi * f * frac))
        y = y[i0:].astype(np.complex64)
        # decision-rate soft values straight from the matched filter
        shifted = np.concatenate([[1.0 + 0j], y[:-1]])
        fr = np.angle(y * np.conj(shifted)).astype(np.float32)
        z = np.convolve(fr, self._rx_h)[: fr.size]
        # causal conv: z[n] = sum h[j] fr[n-j]; bit j decided at z[j*k],
        # delayed 2m bits (tx pulse m + rx filter m)
        d = z[:: self.k]
        start = 2 * self.m
        bits_sig = d[start:]
        scale = np.median(np.abs(bits_sig[:_PRE_LEN])) + 1e-12
        soft = np.clip(0.5 + 0.5 * bits_sig / (2.0 * scale), 0.0, 1.0)
        hdr_nbits = 8 * self.header_pk.enc_len
        if soft.size < _PRE_LEN + hdr_nbits:
            return None
        # preamble EVM (bit error proxy): sign agreement
        pre = _preamble_bits()
        got = (bits_sig[:_PRE_LEN] > 0).astype(np.uint8)
        pre_match = float(np.mean(got == pre))
        hdr_soft = soft[_PRE_LEN: _PRE_LEN + hdr_nbits]
        header_all, hok = self.header_pk.decode_soft(
            hdr_soft.astype(np.float32))
        stats = {"rxy": det["rxy"], "tau": tau, "dphi": dphi,
                 "preamble_match": pre_match}
        if not hok:
            return {"header": header_all[: self.header_len],
                    "header_valid": False, "payload": None,
                    "payload_valid": False, "props": None, "stats": stats}
        user = header_all[: self.header_len]
        proto = header_all[self.header_len:]
        payload_len = (int(proto[0]) << 8) | int(proto[1])
        crc_id, fec0_id, fec1_id = int(proto[2]), int(proto[3]), int(proto[4])
        if (payload_len < 1 or crc_id >= len(_CRC_IDS)
                or fec0_id >= len(_FEC_IDS) or fec1_id >= len(_FEC_IDS)):
            return {"header": user, "header_valid": True, "payload": None,
                    "payload_valid": False, "props": None, "stats": stats}
        props = {"crc": _CRC_IDS[crc_id], "fec0": _FEC_IDS[fec0_id],
                 "fec1": _FEC_IDS[fec1_id], "payload_len": payload_len}
        payload_pk = Packetizer(payload_len, crc=props["crc"],
                                fec0=props["fec0"], fec1=props["fec1"])
        pl_nbits = 8 * payload_pk.enc_len
        off = _PRE_LEN + hdr_nbits
        if soft.size < off + pl_nbits:
            return {"header": user, "header_valid": True, "payload": None,
                    "payload_valid": False, "props": props, "stats": stats}
        payload, pok = payload_pk.decode_soft(
            soft[off: off + pl_nbits].astype(np.float32))
        return {"header": user, "header_valid": True, "payload": payload,
                "payload_valid": bool(pok), "props": props, "stats": stats}
