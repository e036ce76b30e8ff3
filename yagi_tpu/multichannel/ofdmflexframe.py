"""ofdmflexframe: OFDM burst frame with in-band signaled payload format.

Fills part of the reference's unported multichannel layer (SURVEY.md §2.6:
``ofdmflexframe_*`` rows in LIQUID_COMPAT.md:1106-1120). Behavioral spec is
liquid-dsp's ofdmflexframegen/ofdmflexframesync: an OFDM burst (M
subcarriers, cyclic prefix, S0/S1 sync preamble) carrying a protected
header that signals the payload configuration (length, modulation, CRC,
two FEC levels) followed by the payload; the synchronizer detects the
frame, equalizes, decodes the header, reconstructs the payload decoder,
and validates the payload.

Block-parallel: all OFDM (de)modulation is the batched-FFT OfdmFrameGen/Sync
(one IFFT/FFT over [num_symbols, M]); header/payload bit processing is the
QPacketModem (batched modem gather/argmin + Viterbi scan).
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError
from ..fec.api import FecScheme
from ..fec.crc import CrcScheme
from ..framing.qpacketmodem import QPacketModem
from ..modem.modem import ModulationScheme
from .ofdm import OfdmFrameGen, OfdmFrameSync

__all__ = ["OfdmFlexFrameGen", "OfdmFlexFrameSync"]

_MOD_IDS = tuple(s.value for s in ModulationScheme if s.value != "arb")
_CRC_IDS = tuple(s.value for s in CrcScheme)
_FEC_IDS = tuple(s.value for s in FecScheme)
_PROTOCOL_BYTES = 6


def _header_pm(user_len: int) -> QPacketModem:
    return QPacketModem(user_len + _PROTOCOL_BYTES, crc="crc32",
                        fec0="golay2412", fec1="none", mod_scheme="qpsk")


class OfdmFlexFrameGen:
    """OFDM flexible frame generator (liquid ``ofdmflexframegen``)."""

    def __init__(self, M: int = 64, cp_len: int = 16, sctype=None,
                 header_len: int = 14):
        if header_len < 0:
            raise ConfigError(f"header length ({header_len}) must be >= 0")
        self.gen = OfdmFrameGen(M, cp_len, sctype)
        self.header_len = header_len
        self.header_pm = _header_pm(header_len)

    def assemble(self, header, payload, mod_scheme: str = "qpsk",
                 crc: str = "crc32", fec0: str = "none",
                 fec1: str = "none") -> np.ndarray:
        """Build one OFDM frame; returns time samples complex64."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        if header.size != self.header_len:
            raise ConfigError(
                f"header length {header.size} != {self.header_len}")
        if payload.size < 1 or payload.size > 65535:
            raise ConfigError(
                f"payload length ({payload.size}) must be in [1, 65535]")
        try:
            mod_id = _MOD_IDS.index(
                ModulationScheme.from_str(mod_scheme).value)
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
            self.header_pm.encode(np.concatenate([header, protocol])),
            payload_pm.encode(payload),
        ])
        nd = self.gen.n_data
        n_ofdm = -(-syms.size // nd)
        grid = np.zeros(n_ofdm * nd, dtype=np.complex64)
        grid[: syms.size] = syms
        return self.gen.assemble(grid.reshape(n_ofdm, nd))


class OfdmFlexFrameSync:
    """OFDM flexible frame synchronizer (liquid ``ofdmflexframesync``)."""

    def __init__(self, M: int = 64, cp_len: int = 16, sctype=None,
                 header_len: int = 14, threshold: float = 0.6):
        self.sync = OfdmFrameSync(M, cp_len, sctype, threshold=threshold)
        self.header_len = header_len
        self.header_pm = _header_pm(header_len)

    def execute(self, x):
        """Search buffer ``x``; None or dict with header/payload/props/stats."""
        x = np.asarray(x, dtype=np.complex64).ravel()
        nd = self.sync.n_data
        hlen = self.header_pm.get_frame_len()
        n_hdr_ofdm = -(-hlen // nd)
        # enough buffer for preamble + header OFDM symbols?
        if x.size < (3 + n_hdr_ofdm) * self.sync.sym_len:
            return None
        res = self.sync.execute(x, n_hdr_ofdm)
        if res is None:
            return None
        hdr_syms = res["symbols"].reshape(-1)[:hlen].astype(np.complex64)
        header_all, hok = self.header_pm.decode_soft(hdr_syms)
        user = header_all[: self.header_len]
        if not hok:
            return {"header": user, "header_valid": False, "payload": None,
                    "payload_valid": False, "props": None,
                    "stats": res["stats"]}
        proto = header_all[self.header_len:]
        payload_len = (int(proto[0]) << 8) | int(proto[1])
        mod_id, crc_id, fec0_id, fec1_id = (int(proto[2]), int(proto[3]),
                                            int(proto[4]), int(proto[5]))
        if (payload_len < 1 or mod_id >= len(_MOD_IDS)
                or crc_id >= len(_CRC_IDS) or fec0_id >= len(_FEC_IDS)
                or fec1_id >= len(_FEC_IDS)):
            return {"header": user, "header_valid": True, "payload": None,
                    "payload_valid": False, "props": None,
                    "stats": res["stats"]}
        props = {"mod_scheme": _MOD_IDS[mod_id], "crc": _CRC_IDS[crc_id],
                 "fec0": _FEC_IDS[fec0_id], "fec1": _FEC_IDS[fec1_id],
                 "payload_len": payload_len}
        payload_pm = QPacketModem(payload_len, crc=props["crc"],
                                  fec0=props["fec0"], fec1=props["fec1"],
                                  mod_scheme=props["mod_scheme"])
        total = hlen + payload_pm.get_frame_len()
        n_ofdm = -(-total // nd)
        if x.size < (3 + n_ofdm) * self.sync.sym_len:
            return {"header": user, "header_valid": True, "payload": None,
                    "payload_valid": False, "props": props,
                    "stats": res["stats"]}
        res2 = self.sync.execute(x, n_ofdm)
        if res2 is None:
            return {"header": user, "header_valid": True, "payload": None,
                    "payload_valid": False, "props": props,
                    "stats": res["stats"]}
        allsyms = res2["symbols"].reshape(-1)
        pld_syms = allsyms[hlen: total].astype(np.complex64)
        payload, pok = payload_pm.decode_soft(pld_syms)
        return {"header": user, "header_valid": True, "payload": payload,
                "payload_valid": bool(pok), "props": props,
                "stats": res2["stats"]}
