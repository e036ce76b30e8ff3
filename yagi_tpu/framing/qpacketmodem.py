"""qpacketmodem: packet encoder/modulator + demodulator/decoder.

Fills part of the reference's unported framing layer (SURVEY.md §2.6:
``qpacketmodem`` rows in LIQUID_COMPAT.md:1009-1283). Behavioral spec is
liquid-dsp's qpacketmodem: a payload byte message is protected by the
packetizer (CRC + two FEC levels + interleaving) and mapped to modem
symbols; the receiver demodulates (hard or soft) and runs the inverse
chain, reporting CRC validity.

Block-parallel: modulation/demodulation are the batched Modem ops (one gather /
one argmin over the block); soft decoding feeds the Viterbi lax.scan.
The packet-rate FEC framing stays host-side numpy, as in the fec module.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError
from ..fec import Packetizer
from ..fec._bits import pack_bits, unpack_bits
from ..modem.modem import Modem

__all__ = ["QPacketModem"]


class QPacketModem:
    """Packet modem (liquid ``qpacketmodem``).

    Parameters mirror ``qpacketmodem_create(payload_len, crc, fec0, fec1,
    ms)``.
    """

    def __init__(self, payload_len: int, crc="crc32", fec0="none",
                 fec1="none", mod_scheme="qpsk"):
        self.packetizer = Packetizer(payload_len, crc=crc, fec0=fec0,
                                     fec1=fec1)
        self.modem = Modem.create(mod_scheme)
        self.payload_len = payload_len
        self.bps = self.modem.get_bps()
        nbits = 8 * self.packetizer.enc_len
        self.frame_len = -(-nbits // self.bps)  # symbols, zero-padded

    def get_frame_len(self) -> int:
        """Number of modem symbols per packet (liquid
        ``qpacketmodem_get_frame_len``)."""
        return self.frame_len

    def get_payload_len(self) -> int:
        return self.payload_len

    # ------------------------------------------------------------- encode

    def encode_syms(self, payload) -> np.ndarray:
        """Payload bytes -> symbol indices [frame_len]."""
        enc = self.packetizer.encode(payload)
        bits = unpack_bits(enc)
        pad = self.frame_len * self.bps - bits.shape[-1]
        if pad:
            bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
        groups = bits.reshape(self.frame_len, self.bps)
        weights = (1 << np.arange(self.bps - 1, -1, -1)).astype(np.int64)
        return (groups.astype(np.int64) @ weights).astype(np.uint32)

    def encode(self, payload):
        """Payload bytes -> modulated samples [frame_len] complex64."""
        syms = self.encode_syms(payload)
        samples, _ = self.modem.modulate(syms)
        return np.asarray(samples)

    # ------------------------------------------------------------- decode

    def _bits_from_syms(self, syms: np.ndarray) -> np.ndarray:
        bits = (syms[:, None].astype(np.int64)
                >> np.arange(self.bps - 1, -1, -1)) & 1
        return bits.reshape(-1)[: 8 * self.packetizer.enc_len].astype(np.uint8)

    def decode_syms(self, syms):
        """Hard symbol indices [frame_len] -> (payload, crc_pass)."""
        syms = np.asarray(syms).ravel()
        if syms.shape[0] != self.frame_len:
            raise ConfigError(
                f"frame length {syms.shape[0]} != {self.frame_len}")
        enc = pack_bits(self._bits_from_syms(syms))
        return self.packetizer.decode(enc)

    def decode(self, samples):
        """Received samples [frame_len] -> (payload, crc_pass), hard
        decisions."""
        samples = np.asarray(samples).ravel()
        if samples.shape[0] != self.frame_len:
            raise ConfigError(
                f"frame length {samples.shape[0]} != {self.frame_len}")
        syms, _ = self.modem.demodulate(samples)
        return self.decode_syms(np.asarray(syms))

    def decode_soft(self, samples):
        """Received samples -> (payload, crc_pass) via per-bit soft
        decisions (liquid ``qpacketmodem_decode_soft``)."""
        samples = np.asarray(samples).ravel()
        if samples.shape[0] != self.frame_len:
            raise ConfigError(
                f"frame length {samples.shape[0]} != {self.frame_len}")
        _, soft, _ = self.modem.demodulate_soft(samples)
        levels = np.asarray(soft, dtype=np.float32).reshape(-1) / 255.0
        levels = levels[: 8 * self.packetizer.enc_len]
        return self.packetizer.decode_soft(levels)
