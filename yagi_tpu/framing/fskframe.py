"""fskframe: FSK-modulated burst frame generator + synchronizer.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``fskframesync`` row in LIQUID_COMPAT.md:1073-1076). Behavioral spec is
liquid-dsp's fskframegen/fskframesync: a burst frame carried on M-ary FSK
(m bits/symbol, k samples/symbol, bandwidth bw) — p/n preamble, protected
header carrying the payload configuration (length, CRC, FEC levels),
protected payload; the synchronizer detects the burst, recovers timing and
carrier offset, and decodes non-coherently (FSK tone energies are
insensitive to carrier phase and channel gain).

Block-parallel: modulation is the block Fskmod (one u32 phase cumsum);
demodulation is the block Fskdem (one batched K-point FFT over all symbol
frames + argmax); detection reuses the QDetector FFT correlation bank over
the deterministic FSK preamble waveform.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError
from ..fec import Packetizer
from ..fec._bits import pack_bits, unpack_bits
from ..fec.api import FecScheme
from ..fec.crc import CrcScheme
from ..modem.fsk import Fskmod, Fskdem
from ..sequence.msequence import MSequence
from .qdetector import QDetector

__all__ = ["FskFrameGen", "FskFrameSync"]

_PRE_SYMS = 64
_CRC_IDS = tuple(s.value for s in CrcScheme)
_FEC_IDS = tuple(s.value for s in FecScheme)
_PROTOCOL_BYTES = 5


def _preamble_symbols(m: int) -> np.ndarray:
    ms = MSequence.create_default(7)
    M = 1 << m
    out = np.empty(_PRE_SYMS, dtype=np.int32)
    for i in range(_PRE_SYMS):
        v = 0
        for _ in range(m):
            v = (v << 1) | ms.advance()
        out[i] = v % M
    return out


def _header_pk(user_len: int) -> Packetizer:
    return Packetizer(user_len + _PROTOCOL_BYTES, crc="crc32",
                      fec0="golay2412", fec1="none")


def _bytes_to_syms(data: np.ndarray, m: int) -> np.ndarray:
    bits = unpack_bits(data)
    pad = (-bits.size) % m
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    groups = bits.reshape(-1, m)
    weights = (1 << np.arange(m - 1, -1, -1)).astype(np.int64)
    return (groups.astype(np.int64) @ weights).astype(np.int32)


def _syms_to_bytes(syms: np.ndarray, m: int, nbytes: int) -> np.ndarray:
    bits = ((syms[:, None].astype(np.int64)
             >> np.arange(m - 1, -1, -1)) & 1).reshape(-1)
    return pack_bits(bits[: 8 * nbytes].astype(np.uint8))


class FskFrameGen:
    """FSK burst frame generator (liquid ``fskframegen``)."""

    def __init__(self, m: int = 1, k: int = 8, bandwidth: float = 0.25,
                 header_len: int = 8):
        if header_len < 0:
            raise ConfigError(f"header length ({header_len}) must be >= 0")
        self.m, self.k, self.bandwidth = m, k, float(bandwidth)
        self.header_len = header_len
        self.header_pk = _header_pk(header_len)
        Fskmod.create(m, k, bandwidth)  # validates m/k/bandwidth

    def assemble(self, header, payload, crc: str = "crc32",
                 fec0: str = "none", fec1: str = "none") -> np.ndarray:
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
        syms = np.concatenate([
            _preamble_symbols(self.m),
            _bytes_to_syms(self.header_pk.encode(
                np.concatenate([header, protocol])), self.m),
            _bytes_to_syms(payload_pk.encode(payload), self.m),
        ])
        mod = Fskmod.create(self.m, self.k, self.bandwidth)
        y, _ = mod.modulate(syms)
        return np.asarray(y, dtype=np.complex64)


class FskFrameSync:
    """FSK burst frame synchronizer (liquid ``fskframesync``)."""

    def __init__(self, m: int = 1, k: int = 8, bandwidth: float = 0.25,
                 header_len: int = 8, threshold: float = 0.5,
                 dphi_max: float = 0.02, n_dphi: int = 13):
        self.m, self.k, self.bandwidth = m, k, float(bandwidth)
        self.header_len = header_len
        self.header_pk = _header_pk(header_len)
        self.preamble = _preamble_symbols(m)
        mod = Fskmod.create(m, k, bandwidth)
        template, _ = mod.modulate(self.preamble)
        self.detector = QDetector(np.asarray(template), threshold=threshold,
                                  dphi_max=dphi_max, n_dphi=n_dphi)

    def _hdr_nsyms(self) -> int:
        return -(-8 * self.header_pk.enc_len // self.m)

    def execute(self, x):
        """Search buffer; None or dict with header/payload/props/stats."""
        x = np.asarray(x, dtype=np.complex64).ravel()
        det = self.detector.detect(x)
        if det is None:
            return None
        tau, dphi = det["tau"], det["dphi"]
        n = np.arange(x.size)
        y = x * np.exp(-1j * dphi * n)  # CFO removal; phase/gain moot
        i0 = int(round(tau))
        y = y[i0:]
        navail = y.size // self.k
        hdr_nsyms = self._hdr_nsyms()
        if navail < _PRE_SYMS + hdr_nsyms:
            return None
        dem = Fskdem.create(self.m, self.k, self.bandwidth)
        syms, _ = dem.demodulate(y[: navail * self.k])
        syms = np.asarray(syms)
        pre_match = float(np.mean(syms[:_PRE_SYMS] == self.preamble))
        hdr_syms = syms[_PRE_SYMS: _PRE_SYMS + hdr_nsyms]
        header_all, hok = self.header_pk.decode(
            _syms_to_bytes(hdr_syms, self.m, self.header_pk.enc_len))
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
        pl_nsyms = -(-8 * payload_pk.enc_len // self.m)
        off = _PRE_SYMS + hdr_nsyms
        if syms.size < off + pl_nsyms:
            return {"header": user, "header_valid": True, "payload": None,
                    "payload_valid": False, "props": props, "stats": stats}
        payload, pok = payload_pk.decode(
            _syms_to_bytes(syms[off: off + pl_nsyms], self.m,
                           payload_pk.enc_len))
        return {"header": user, "header_valid": True, "payload": payload,
                "payload_valid": bool(pok), "props": props, "stats": stats}
