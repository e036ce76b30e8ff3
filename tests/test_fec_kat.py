"""Published known-answer tests for FEC.

The roundtrip FEC validation is largely self-derived (roundtrips, error
correction); these pin the implementations to PUBLISHED vectors and
mathematical invariants:

* CRC check values for the standard 9-byte test message "123456789"
  (the `check` field of the CRC catalogue, reveng/Williams):
  CRC-8/SMBUS 0xF4, CRC-16/ARC 0xBB3D, CRC-32/ISO-HDLC 0xCBF43926.
  liquid's crc24 uses its own 0x5D6DCB polynomial (not OpenPGP), so its
  value is pinned as a regression anchor.
* Extended binary Golay(24,12): weight enumerator 1 + 759·x^8 + 2576·x^12 +
  759·x^16 + x^24 (MacWilliams & Sloane, ch. 2 §6), minimum distance 8 —
  enumerated over all 4096 codewords, independent of bit conventions.
* Hamming(7,4): weight enumerator 1 + 7·x^3 + 7·x^4 + x^7; extended
  Hamming(8,4): 1 + 14·x^4 + x^8.
* RS(255,223), ka9q/CCSDS parameters (field poly 0x187, fcr=112, prim=11):
  the generator polynomial must vanish exactly on the 32 published roots
  α^(prim·(fcr+i)), and nowhere else.
"""

import numpy as np
import pytest

from yagi_tpu.fec.crc import checksum, crc8, crc16, crc24, crc32

_MSG = b"123456789"


class TestCrcKat:
    def test_crc8_smbus_check(self):
        assert crc8(_MSG) == 0xF4  # CRC-8/SMBUS published check value

    def test_crc16_arc_check(self):
        assert crc16(_MSG) == 0xBB3D  # CRC-16/ARC published check value

    def test_crc32_iso_hdlc_check(self):
        assert crc32(_MSG) == 0xCBF43926  # CRC-32/ISO-HDLC published check

    def test_crc24_liquid_poly_anchor(self):
        # liquid's own 0x5D6DCB polynomial (not OpenPGP 0x864CFB); pinned
        assert crc24(_MSG) == 0xA41D1B

    def test_checksum_mod256(self):
        assert checksum(_MSG) == (-sum(_MSG)) & 0xFF


class TestGolayKat:
    def test_weight_enumerator_and_min_distance(self):
        """1 + 759x^8 + 2576x^12 + 759x^16 + x^24 (MacWilliams-Sloane)."""
        from yagi_tpu.fec.golay import Golay2412

        g = Golay2412()
        msgs = np.arange(4096, dtype=np.uint32)
        bits = ((msgs[:, None] >> np.arange(11, -1, -1)[None, :]) & 1).astype(
            np.uint8
        )
        cw = np.asarray(g.encode_bits(bits)).reshape(4096, 24)
        w = cw.sum(axis=1).astype(np.int64)
        hist = np.bincount(w, minlength=25)
        expect = np.zeros(25, dtype=int)
        expect[0], expect[8], expect[12], expect[16], expect[24] = (
            1, 759, 2576, 759, 1,
        )
        np.testing.assert_array_equal(hist, expect)
        assert w[w > 0].min() == 8  # minimum distance

    def test_three_error_correction_published_capability(self):
        from yagi_tpu.fec.golay import Golay2412

        rng = np.random.default_rng(0)
        g = Golay2412()
        bits = rng.integers(0, 2, size=(50, 12)).astype(np.uint8)
        cw = np.asarray(g.encode_bits(bits)).reshape(50, 24)
        for row in range(50):
            errpos = rng.choice(24, size=3, replace=False)
            r = cw[row].copy()
            r[errpos] ^= 1
            dec = np.asarray(g.decode_bits(r[None, :])[0]).reshape(-1)[:12]
            np.testing.assert_array_equal(dec, bits[row])


class TestHammingKat:
    @pytest.mark.parametrize(
        "maker,n,expect_pairs",
        [
            ("hamming74", 7, {0: 1, 3: 7, 4: 7, 7: 1}),
            ("hamming84", 8, {0: 1, 4: 14, 8: 1}),
        ],
    )
    def test_weight_enumerator(self, maker, n, expect_pairs):
        from yagi_tpu.fec import block

        code = getattr(block, maker)()
        msgs = np.arange(16, dtype=np.uint32)
        bits = ((msgs[:, None] >> np.arange(3, -1, -1)[None, :]) & 1).astype(
            np.uint8
        )
        cw = np.asarray(code.encode_bits(bits)).reshape(16, n)
        hist = np.bincount(cw.sum(axis=1).astype(np.int64), minlength=n + 1)
        expect = np.zeros(n + 1, dtype=int)
        for k, v in expect_pairs.items():
            expect[k] = v
        np.testing.assert_array_equal(hist, expect)


class TestRsKat:
    def test_generator_roots_ccsds_parameters(self):
        """g(x) vanishes exactly on the 32 roots α^(prim·(fcr+i)) of the
        published ka9q RS(255,223) parameterization."""
        from yagi_tpu.fec.rs import ReedSolomon

        rs = ReedSolomon()
        assert (rs.fcr, rs.prim, rs.nroots) == (112, 11, 32)
        # encode the zero message + a delta to extract parity behavior is
        # convention-dependent; instead check the generator directly
        g = np.asarray(rs.genpoly, dtype=np.int64)  # coefficients, GF(256)
        exp = np.asarray(rs.gf.exp, dtype=np.int64)
        log = np.asarray(rs.gf.log, dtype=np.int64)

        def gf_eval(poly, xlog):
            acc = 0
            for c in poly:
                # acc = acc·x + c in GF(256)
                if acc:
                    acc = int(exp[(int(log[acc]) + xlog) % 255])
                acc ^= int(c)
            return acc

        roots = [(rs.prim * (rs.fcr + i)) % 255 for i in range(rs.nroots)]
        for r in roots:
            assert gf_eval(g, r) == 0, f"α^{r} must be a root"
        nonroots = [r for r in range(255) if r not in roots]
        assert all(gf_eval(g, r) != 0 for r in nonroots[:32])

    def test_t16_correction_published_capability(self):
        from yagi_tpu.fec.rs import ReedSolomon

        rng = np.random.default_rng(1)
        rs = ReedSolomon()
        data = rng.integers(0, 256, size=(1, 223)).astype(np.uint8)
        cw = np.asarray(rs.encode_blocks(data))
        r = cw.copy()
        pos = rng.choice(255, size=16, replace=False)
        r[0, pos] ^= rng.integers(1, 256, size=16).astype(np.uint8)
        dec, nerr = rs.decode_blocks(r)
        np.testing.assert_array_equal(np.asarray(dec)[0, :223], data[0])
