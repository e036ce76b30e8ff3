"""Forward error correction (fills the reference's empty ``fec/`` module).

The reference declares ``src/fec/mod.rs`` (0 bytes) — the behavioral spec
comes from liquid-dsp's fec module (LIQUID_COMPAT.md:139-359 enumerates the
feature set): CRC checksums, repetition codes, the Hamming family, SECDED,
Golay(24,12), convolutional codes (ka9q K=7/K=9/K=15 polynomials, plus
punctured rates), Reed-Solomon (255,223), a block interleaver, and the
packetizer that composes them.

Block-parallel design (not a translation — the reference has no code here):

- Linear block codes (Hamming/SECDED/Golay/rep) are expressed as *batched
  mod-2 matrix products*: encode is ``bits @ G % 2``, syndrome is
  ``bits @ H.T % 2`` — integer matmuls, batched
  over an arbitrary number of codewords at once.
- Convolutional encode is binary convolution mod 2 (one XLA conv); Viterbi
  decode is a ``lax.scan`` over time whose body updates all 2^(K-1) path
  metrics simultaneously (vectorized add-compare-select) — the classic
  SIMD-Viterbi layout, which maps directly onto vector units.
- Reed-Solomon runs host-side in vectorized numpy over blocks (GF(256)
  log/antilog tables); it is a packet-rate operation, not a sample-rate one.

Byte-level APIs mirror liquid's (MSB-first bit packing).
"""

from .crc import (
    CrcScheme, crc_generate_key, crc_validate_message, crc_sizeof_key,
    checksum, crc8, crc16, crc24, crc32,
)
from .block import (
    LinearBlockCode, RepetitionCode, hamming74, hamming84, hamming128,
    hamming1511, hamming3126, secded2216, secded3932, secded7264,
    rep3, rep5,
)
from .golay import Golay2412, golay2412
from .conv import ConvCode, PuncturedConvCode, conv27, conv29, conv39, conv615, conv_punctured
from .rs import ReedSolomon, rs8
from .interleave import Interleaver
from .api import Fec, FecScheme, fec_get_enc_msg_length
from .packetizer import Packetizer

__all__ = [
    "CrcScheme", "crc_generate_key", "crc_validate_message", "crc_sizeof_key",
    "checksum", "crc8", "crc16", "crc24", "crc32",
    "LinearBlockCode", "RepetitionCode", "hamming74", "hamming84",
    "hamming128", "hamming1511", "hamming3126", "secded2216", "secded3932",
    "secded7264", "rep3", "rep5",
    "Golay2412", "golay2412",
    "ConvCode", "PuncturedConvCode", "conv27", "conv29", "conv39", "conv615",
    "conv_punctured",
    "ReedSolomon", "rs8",
    "Interleaver",
    "Fec", "FecScheme", "fec_get_enc_msg_length",
    "Packetizer",
]
