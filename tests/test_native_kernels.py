"""Native C ABI shim tests.

The native test proves the C++ implementation of liquid's bsequence ABI
(which the reference left unimplemented) matches the Python BSequence
bit-for-bit. The oscillator test pins the exact-mode block mixer that the
fused chain kernel reproduces (kernels/chain.py) against a float64 model of
its wrapping u32 phase ramp.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tests.autotest import autotest
from yagi_tpu.sequence import BSequence, MSequence


class TestLibrarySanity:
    @autotest("libliquid", "null")
    def test_package_links_and_versions(self):
        """Library-level sanity (liquid autotest_libliquid / autotest_null:
        version string resolves and the library links). Package analog:
        __version__ present, every public subpackage imports, and the
        native C shim loader responds."""
        import importlib
        import yagi_tpu
        assert isinstance(yagi_tpu.__version__, str)
        assert len(yagi_tpu.__version__.split(".")) >= 2
        for sub in ("math", "fft", "design", "filter", "nco", "agc",
                    "equalization", "modem", "fec", "framing",
                    "multichannel", "parallel", "chains", "kernels",
                    "audio", "random", "matrix", "optim", "quantization",
                    "channel", "sequence", "utils", "errors"):
            importlib.import_module(f"yagi_tpu.{sub}")
        from yagi_tpu.native import native_available
        assert native_available() in (True, False)


class TestNativeBsequence:
    @pytest.fixture(scope="class")
    def native(self):
        from yagi_tpu.native import native_available

        if not native_available():
            pytest.skip("native library not built (g++ unavailable)")
        from yagi_tpu.native import NativeBSequence

        return NativeBSequence

    def test_matches_python(self, native):
        ms = MSequence.create_default(7)
        py = BSequence.from_msequence(ms)
        ms.reset()
        nb = native(ms.get_length())
        for _ in range(ms.get_length()):
            nb.push(ms.advance())
        assert nb.accumulate() == py.accumulate()
        for i in range(py.get_length()):
            assert nb.index(i) == py.index(i)

    def test_correlate(self, native):
        a, b = native.create_ccodes(64)
        pa, pb = BSequence.create_ccodes(64)
        assert a.correlate(a) == pa.correlate(pa) == 64
        assert a.correlate(b) == pa.correlate(pb)

    def test_add_mul(self, native):
        a, b = native.create_ccodes(32)
        pa, pb = BSequence.create_ccodes(32)
        assert a.add(b).accumulate() == pa.add(pb).accumulate()
        assert a.mul(b).accumulate() == pa.mul(pb).accumulate()

    def test_init_bytes(self, native):
        data = bytes([0xDE, 0xAD, 0xBE, 0xEF])
        nb = native(32)
        nb.init(data)
        py = BSequence(32)
        py.init(data)
        for i in range(32):
            assert nb.index(i) == py.index(i)

    def test_circshift(self, native):
        nb = native(16)
        nb.init(bytes([0x80, 0x01]))
        py = BSequence(16)
        py.init(bytes([0x80, 0x01]))
        for _ in range(5):
            nb.circshift()
            py.circshift()
        for i in range(16):
            assert nb.index(i) == py.index(i)


class TestExactMixer:
    def test_mix_block_down_matches_u32_ramp(self):
        """Osc.mix_block_down ("exact") == x·exp(-j·2π·θ_n/2^32) with the
        u32 phase θ_n = θ0 + n·dθ wrapping mod 2^32."""
        from yagi_tpu.nco import Osc

        n = 32768
        rng = np.random.default_rng(0)
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
        o = Osc.create("exact").set_frequency(0.37).set_phase(1.1)
        y, o2 = o.mix_block_down(jnp.asarray(x))
        th0, dth = int(o.theta), int(o.d_theta)
        theta = (th0 + np.arange(n, dtype=np.uint64) * dth) % (1 << 32)
        ref = x * np.exp(-2j * np.pi * theta.astype(np.float64) / 2.0**32)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-5, atol=1e-5)
        assert int(o2.theta) == (th0 + n * dth) % (1 << 32)


class TestIqStreamLoader:
    """Native double-buffered IQ reader (native/iq_loader.cpp)."""

    @pytest.mark.parametrize("fmt", ["cf32", "ci16", "cu8"])
    def test_roundtrip_formats(self, fmt, tmp_path):
        from yagi_tpu.native import IqStreamLoader, native_available

        if not native_available():
            pytest.skip("native toolchain unavailable")
        rng = np.random.default_rng(3)
        n = 7000  # not a multiple of the block size (exercises EOF tail)
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.5
        path = tmp_path / f"capture.{fmt}"
        inter = np.empty(2 * n, np.float32)
        inter[0::2] = x.real
        inter[1::2] = x.imag
        if fmt == "cf32":
            path.write_bytes(inter.astype(np.float32).tobytes())
            expect_re, expect_im = inter[0::2], inter[1::2]
        elif fmt == "ci16":
            q = np.clip(np.round(inter * 32768), -32768, 32767).astype(np.int16)
            path.write_bytes(q.tobytes())
            expect_re = q[0::2].astype(np.float32) / 32768
            expect_im = q[1::2].astype(np.float32) / 32768
        else:
            q = np.clip(np.round(inter * 128) + 128, 0, 255).astype(np.uint8)
            path.write_bytes(q.tobytes())
            expect_re = (q[0::2].astype(np.float32) - 128) / 128
            expect_im = (q[1::2].astype(np.float32) - 128) / 128

        got_re, got_im = [], []
        with IqStreamLoader(path, fmt, block_samples=2048) as src:
            for re, im in src:
                got_re.append(re)
                got_im.append(im)
            assert src.total_read() == n
        np.testing.assert_allclose(np.concatenate(got_re), expect_re, atol=0)
        np.testing.assert_allclose(np.concatenate(got_im), expect_im, atol=0)

    def test_open_errors(self, tmp_path):
        from yagi_tpu.native import IqStreamLoader, native_available

        if not native_available():
            pytest.skip("native toolchain unavailable")
        with pytest.raises(OSError):
            IqStreamLoader(tmp_path / "missing.iq")
        with pytest.raises(ValueError):
            IqStreamLoader(__file__, fmt="bogus")
