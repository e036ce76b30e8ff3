"""Arbitrary resampler + NCO conformance tests.

The resampler oracle is a direct NumPy re-implementation of the reference's
per-sample u32 phase loop (resamp.rs:141-154); the block-parallel formulation must match
it output-for-output and phase-for-phase (bit-exact integer schedule, float32
tolerance on sample values). NCO oracle: u32 phase ramp + LUT semantics
(nco.rs:47-51, vco.rs, osc.rs:191-200).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.autotest import autotest
from yagi_tpu.errors import ConfigError
from yagi_tpu.filter import Resamp
from yagi_tpu.filter.firpfb import pfb_decompose
from yagi_tpu.nco import Osc


def reference_resamp(x, branches, phase0, step, bits):
    """Per-sample replay of resamp.rs:141-154 in exact integer arithmetic."""
    npfb, L = branches.shape
    window = np.zeros(L, dtype=x.dtype)
    phase = int(phase0)
    step = int(step)
    ys = []
    branch_log = []
    for xi in x:
        window = np.roll(window, -1)
        window[-1] = xi
        while phase <= 0x00FFFFFF:
            index = phase >> (24 - bits)
            # y = dotprod(branch, window oldest..newest), branch conv-order
            y = np.sum(branches[index][::-1] * window)
            ys.append(y)
            branch_log.append(index)
            phase += step
        phase -= 1 << 24
    return np.asarray(ys), phase, branch_log


class TestResamp:
    @pytest.mark.parametrize("rate", [0.5, 1.0, 1.1, 2.0] + [
        pytest.param(r, marks=pytest.mark.slow) for r in (0.37, 3.7)])
    def test_matches_reference_loop(self, rate):
        rng = np.random.default_rng(int(rate * 100))
        q = Resamp.create(rate, m=3, npfb=32, dtype=jnp.float32)
        branches = np.asarray(q.branches)
        x = rng.normal(size=200).astype(np.float32)

        y_ref, phase_ref, branch_log = reference_resamp(
            x, branches, 0, int(np.asarray(q.step)), q.bits
        )
        y, num_out, q2 = q.execute_block(x)
        num_out = int(num_out)
        assert num_out == len(y_ref), f"count mismatch rate={rate}"
        np.testing.assert_allclose(
            np.asarray(y)[:num_out], y_ref, rtol=1e-4, atol=1e-5
        )
        np.testing.assert_array_equal(np.asarray(y)[num_out:], 0.0)
        assert int(np.asarray(q2.phase)) == phase_ref % (1 << 32)

    def test_block_split_invariance(self):
        rate = 1.7
        rng = np.random.default_rng(9)
        x = (rng.normal(size=300) + 1j * rng.normal(size=300)).astype(np.complex64)

        q1 = Resamp.create(rate, m=5, npfb=64)
        y1, n1, _ = q1.execute_block(x)
        y1 = np.asarray(y1)[: int(n1)]

        q2 = Resamp.create(rate, m=5, npfb=64)
        parts = []
        for chunk in np.split(x, [50, 51, 170]):
            if len(chunk):
                y, n, q2 = q2.execute_block(chunk)
                parts.append(np.asarray(y)[: int(n)])
        y2 = np.concatenate(parts)
        assert len(y1) == len(y2)
        np.testing.assert_allclose(y1, y2, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("rate", [1.0] + [
        pytest.param(2.0, marks=pytest.mark.slow)] + [
        pytest.param(r, marks=pytest.mark.slow)
        for r in (0.5, 4.0 / 3.0, 8.0 / 5.0)])
    def test_static_sched_fast_path_matches_u32(self, rate):
        """The banded static-schedule fast path (P | 2^24, filter/_sched.py)
        equals the u32 gather path sample-for-sample and keeps num_output and
        the phase≡0 invariant across blocks."""
        rng = np.random.default_rng(11)
        x = (rng.normal(size=(2, 480)) + 1j * rng.normal(size=(2, 480))).astype(
            np.complex64
        )
        qf = Resamp.create(rate, m=5, npfb=64, batch_shape=(2,))
        assert qf.exact_sched is not None
        qs = qf.replace(exact_sched=None)  # force the u32 path
        for blk in np.split(x, [120, 360], axis=-1):
            yf, nf, qf = qf.execute_block(blk)
            ys, ns, qs = qs.execute_block(blk)
            assert int(nf) == int(ns)
            np.testing.assert_allclose(
                np.asarray(yf), np.asarray(ys), rtol=2e-6, atol=2e-6
            )
        assert qf.exact_sched is not None  # aligned blocks keep the invariant
        assert int(np.asarray(qs.phase)) == 0

    def test_static_sched_cleared_on_misaligned_block(self):
        q = Resamp.create(0.5, m=4, npfb=32)
        assert q.exact_sched == (1, 2)
        _, _, q = q.execute_block(jnp.zeros(7, dtype=jnp.complex64))
        assert q.exact_sched is None  # 7 % 2 != 0 → u32 path from here on
        _, _, q2 = Resamp.create(0.5, m=4, npfb=32).execute_block(
            jnp.zeros(8, dtype=jnp.complex64)
        )
        assert q2.exact_sched == (1, 2)

    @pytest.mark.slow
    def test_get_num_output(self):
        q = Resamp.create(0.7, m=2, npfb=16)
        # replay must equal actual emission count
        for n in [1, 7, 100]:
            expect = q.get_num_output(n)
            y, k, q = q.execute_block(jnp.zeros(n, dtype=jnp.complex64))
            assert int(k) == expect

    def test_rate_one_identity_delay(self):
        """r=1: output = input delayed by the filter delay, unit gain."""
        q = Resamp.create(1.0, m=7, npfb=256, dtype=jnp.float32)
        t = np.arange(500, dtype=np.float32)
        x = np.sin(2 * np.pi * 0.02 * t).astype(np.float32)
        y, n, _ = q.execute_block(x)
        y = np.asarray(y)[: int(n)]
        assert len(y) == 500
        # skip transient; compare against delayed input
        d = q.get_delay()
        np.testing.assert_allclose(y[2 * d :], x[d : 500 - d], atol=2e-2)

    def test_psd_mask(self):
        """Resampled noise keeps its band, images suppressed (resamp.rs:176-217
        style: spgram-averaged PSD against a region mask)."""
        from yagi_tpu import fft as yfft
        from yagi_tpu.utils import PsdRegion, validate_psd_spgram
        from yagi_tpu.filter import FirFilter
        from yagi_tpu.math.windows import WindowType

        rng = np.random.default_rng(10)
        n = 40000
        # band-limited complex noise via kaiser lowpass (bw 0.4, unit gain)
        noise = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
        lp = FirFilter.create_kaiser(57, 0.2, 60.0)
        lp = lp.set_scale(2 * 0.2)
        x, _ = lp.execute_block(noise)

        r = 1.4
        q = Resamp.create(r, m=12, npfb=64, as_=60.0)
        y, k, _ = q.execute_block(jnp.asarray(x))
        y = np.asarray(y)[: int(k)]
        sp = yfft.Spgram.create(256, WindowType.HAMMING, 128, 64).write(y)
        # input band ±0.2 maps to ±0.2/1.4 ≈ ±0.143; images beyond 0.357
        regions = [
            PsdRegion(-0.10, 0.10, pmin=-4.0, test_lo=True),
            PsdRegion(-0.5, -0.35, pmax=-40.0, test_hi=True),
            PsdRegion(0.35, 0.5, pmax=-40.0, test_hi=True),
        ]
        assert validate_psd_spgram(sp, regions)

    def test_invalid(self):
        with pytest.raises(ConfigError):
            Resamp.create(0.0)
        with pytest.raises(ConfigError):
            Resamp.create(1.0, m=0)
        with pytest.raises(ConfigError):
            Resamp.create(1.0, fc=0.7)
        with pytest.raises(ConfigError):
            Resamp.create(300.0)

    @pytest.mark.parametrize("rate", [2.0] + [
        pytest.param(r, marks=pytest.mark.slow)
        for r in (0.75, 1.0, 1.7, 3.1)])
    def test_fused_mix_down_bit_identical(self, rate):
        """execute_block_mix_down == execute_block + mix_block_down_n exactly,
        including resampler phase and oscillator theta carry across blocks."""
        rng = np.random.default_rng(5)
        x = jnp.asarray(
            (rng.standard_normal((3, 1200)) + 1j * rng.standard_normal((3, 1200))
             ).astype(np.complex64)
        )
        rs1 = Resamp.create(rate, batch_shape=(3,))
        osc1 = Osc.create("exact", batch_shape=(3,)).set_frequency(0.2)
        rs2, osc2 = rs1, osc1
        for blk in jnp.split(x, [400, 401], axis=-1):
            ya, ka, rs1 = rs1.execute_block(blk)
            ya, osc1 = osc1.mix_block_down_n(ya, ka)
            yb, kb, rs2, osc2 = rs2.execute_block_mix_down(blk, osc2)
            assert int(np.asarray(ka)) == int(np.asarray(kb))
            np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
        np.testing.assert_array_equal(np.asarray(rs1.phase), np.asarray(rs2.phase))
        np.testing.assert_array_equal(np.asarray(osc1.theta), np.asarray(osc2.theta))


class TestOsc:
    @autotest("nco_crcf_phase", "nco_basic")
    def test_phase_ramp_exact(self):
        """Block mix phase ramp == per-sample stepping (u32 exact)."""
        o = Osc.create("exact").set_frequency(0.1).set_phase(0.3)
        n = 100
        x = np.ones(n, dtype=np.complex64)
        y, o2 = o.mix_block_up(x)

        o_seq = Osc.create("exact").set_frequency(0.1).set_phase(0.3)
        ys = []
        for _ in range(n):
            ys.append(complex(o_seq.mix_up(1.0 + 0j)))
            o_seq = o_seq.step()
        np.testing.assert_allclose(np.asarray(y), ys, rtol=1e-5, atol=1e-6)
        assert int(np.asarray(o2.theta)) == int(np.asarray(o_seq.theta))

    @pytest.mark.parametrize("mode,spur_dbc", [("nco", -60.0), ("vco", -110.0), ("exact", -110.0)])
    def test_tone_purity(self, mode, spur_dbc):
        """Spectral purity per osc.rs:648-681: Hann-windowed spectrum,
        far-out spurs measured relative to the carrier.

        Measured: nco (nearest-LUT) ≈ -66 dBc, vco (interp-LUT) ≈ -132 dBc,
        exact ≈ -147 dBc — the LUT hierarchy the reference documents.
        """
        f0 = 0.123
        n = 4096
        o = Osc.create(mode).set_frequency(2 * np.pi * f0)
        y, _ = o.mix_block_up(np.ones(n, dtype=np.complex64))
        yw = np.asarray(y) * np.hanning(n)
        spec = 20 * np.log10(np.abs(np.fft.fftshift(np.fft.fft(yw, 4 * n))) + 1e-30)
        spec -= spec.max()
        f = np.arange(4 * n) / (4 * n) - 0.5
        far = (f < f0 - 0.05) | (f > f0 + 0.05)
        assert spec[far].max() < spur_dbc

    @autotest("nco_mixing", "nco_block_mixing")
    def test_mix_up_down_roundtrip(self):
        o_up = Osc.create("exact").set_frequency(0.3)
        o_dn = Osc.create("exact").set_frequency(0.3)
        rng = np.random.default_rng(11)
        x = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
        y, _ = o_up.mix_block_up(x)
        z, _ = o_dn.mix_block_down(np.asarray(y))
        np.testing.assert_allclose(np.asarray(z), x, rtol=1e-4, atol=1e-5)

    @autotest("nco_crcf_frequency")
    def test_frequency_accessors(self):
        """set/adjust/get frequency roundtrip (liquid nco_crcf_frequency)."""
        o = Osc.create("exact").set_frequency(0.2)
        assert float(o.get_frequency()) == pytest.approx(0.2, abs=1e-6)
        o = o.adjust_frequency(0.05)
        assert float(o.get_frequency()) == pytest.approx(0.25, abs=1e-6)
        o = o.adjust_frequency(-0.25)
        assert abs(float(o.get_frequency())) < 1e-6
        # mixing at the set frequency produces the expected tone
        o = Osc.create("exact").set_frequency(2 * np.pi * 0.05)
        y, _ = o.mix_block_up(np.ones(64, np.complex64))
        ph = np.angle(np.asarray(y))
        d = np.diff(np.unwrap(ph))
        np.testing.assert_allclose(d, 2 * np.pi * 0.05, atol=1e-4)

    @autotest("nco_crcf_copy")
    def test_copy_midstream(self):
        """Copied oscillator continues bit-identically (nco_crcf_copy)."""
        o0 = Osc.create("exact").set_frequency(0.31).set_phase(0.7)
        _, o0 = o0.mix_block_up(np.ones(37, np.complex64))
        o1 = jax.tree_util.tree_map(lambda v: v, o0)
        y0, _ = o0.mix_block_up(np.ones(23, np.complex64))
        y1, _ = o1.mix_block_up(np.ones(23, np.complex64))
        np.testing.assert_array_equal(np.asarray(y0), np.asarray(y1))

    @autotest("nco_crcf_pll_phase", "nco_crcf_pll_freq")
    def test_pll_locks(self):
        """PLL phase lock (osc.rs:229-312): track a fixed phase offset."""
        phase_offset = 0.7
        freq_offset = 0.02
        bw = 0.05
        n = int(32 / bw)
        tx = Osc.create("vco").set_phase(phase_offset).set_frequency(freq_offset)
        rx = Osc.create("vco").pll_set_bandwidth(bw)
        for _ in range(n):
            dphi = float(tx.get_phase()) - float(rx.get_phase())
            while dphi > np.pi:
                dphi -= 2 * np.pi
            while dphi < -np.pi:
                dphi += 2 * np.pi
            rx = rx.pll_step(dphi)
            tx = tx.step()
            rx = rx.step()
        err = float(tx.get_phase()) - float(rx.get_phase())
        while err > np.pi:
            err -= 2 * np.pi
        while err < -np.pi:
            err += 2 * np.pi
        assert abs(err) < 1e-2
        freq_err = float(tx.get_frequency()) - float(rx.get_frequency())
        assert abs(freq_err) < 1e-2

    @autotest("nco_crcf_constrain")
    def test_constrain(self):
        from yagi_tpu.nco import constrain_phase

        assert int(constrain_phase(0.0)) == 0
        # 2π-periodic
        assert int(constrain_phase(2 * np.pi + 0.5)) == int(constrain_phase(0.5))
        # π maps to ~2^31
        assert abs(int(constrain_phase(np.pi)) - (1 << 31)) < (1 << 22)

    @autotest("nco_config")
    def test_invalid_mode(self):
        with pytest.raises(ConfigError):
            Osc.create("sideways")


@pytest.mark.slow
class TestResampReferenceScenarios:
    """The reference's 17 resamp_crcf autotests (resamp.rs:174-345):
    kaiser-pulse resampling against PSD masks (8 rate/attenuation combos)
    and exact get_num_output bookkeeping over irregular block sizes."""

    _PSD = {
        "00": (0.127115323, 60.0), "01": (0.373737373, 60.0),
        "02": (0.676543210, 60.0), "03": (0.973621947, 60.0),
        "10": (0.127115323, 80.0), "11": (0.373737373, 80.0),
        "12": (0.676543210, 80.0), "13": (0.973621947, 80.0),
    }

    @autotest(param_map={f"[psd-{k}]": f"resamp_crcf_{k}" for k in _PSD})
    @pytest.mark.parametrize("case", sorted(_PSD), ids=[f"psd-{k}" for k in sorted(_PSD)])
    def test_psd(self, case):
        from yagi_tpu import design
        from yagi_tpu.utils import PsdRegion, validate_psd_signal

        r, as_db = self._PSD[case]
        bw, tol, m, npfb, fc = 0.25, 0.6, 20, 2048, 0.45
        rs = Resamp.create(r, m=m, fc=fc, as_=as_db, npfb=npfb)
        p = int(40.0 / r)
        pulse_len = 4 * p + 1
        pulse = design.fir_design_kaiser(pulse_len, 0.5 * r * bw, 120.0, 0.0)
        num_input = pulse_len + 2 * m + 1
        x = np.zeros(num_input, dtype=np.complex64)
        x[:pulse_len] = pulse * bw
        y, nw, _ = rs.execute_block(jnp.asarray(x))
        y = np.asarray(y)[: int(nw)]
        regions = [
            PsdRegion(-0.5, -0.6 * bw, 0.0, -as_db + tol, False, True),
            PsdRegion(-0.4 * bw, 0.4 * bw, -tol, tol, True, True),
            PsdRegion(0.6 * bw, 0.5, 0.0, -as_db + tol, False, True),
        ]
        assert validate_psd_signal(y, regions), case

    _NUMOUT = {
        "0": (1.00, 64), "1": (1.00, 256), "2": (0.50, 256),
        "3": (float(np.sqrt(2.0)), 256), "4": (float(np.sqrt(17.0)), 16),
        "5": (float(1.0 / np.pi), 64), "6": (float(np.exp(5.0)), 64),
        "7": (float(np.exp(-5.0)), 64),
    }

    @autotest(param_map={f"[no-{k}]": f"resamp_crcf_num_output_{k}"
                         for k in _NUMOUT})
    @pytest.mark.parametrize("case", sorted(_NUMOUT), ids=[f"no-{k}" for k in sorted(_NUMOUT)])
    def test_num_output(self, case):
        """get_num_output == actual emissions over irregular block sizes
        (resamp.rs:298-345), covering both the static-schedule fast path
        (rate 1.0) and the u32 gather path (irrational rates)."""
        rate, npfb = self._NUMOUT[case]
        rs = Resamp.create(rate, m=20, fc=0.4, as_=60.0, npfb=npfb)
        sizes = [1, 2, 3, 20, 7, 64, 4, 4, 4, 27]
        for _ in range(8):
            for n in sizes:
                expect = rs.get_num_output(n)
                _, k, rs = rs.execute_block(jnp.zeros(n, dtype=jnp.complex64))
                assert int(k) == expect, (case, n)

    @autotest("resamp_crcf_copy")
    def test_copy(self):
        import jax as _jax

        rng = np.random.default_rng(7)
        q0 = Resamp.create(0.7, m=5, npfb=64)
        x = (rng.normal(size=50) + 1j * rng.normal(size=50)).astype(np.complex64)
        _, _, q0 = q0.execute_block(jnp.asarray(x))
        q1 = _jax.tree_util.tree_map(lambda v: v, q0)
        x2 = (rng.normal(size=50) + 1j * rng.normal(size=50)).astype(np.complex64)
        y0, k0, q0 = q0.execute_block(jnp.asarray(x2))
        y1, k1, q1 = q1.execute_block(jnp.asarray(x2))
        assert int(k0) == int(k1)
        np.testing.assert_array_equal(np.asarray(y0), np.asarray(y1))


class TestNcoReferenceScenarios:
    """The reference's nco_crcf mix (20) and spectrum (10) autotests
    (osc.rs:490-741): block mix against a float phase-recursion oracle for
    NCO/VCO schemes at various phases/frequencies, and oscillator spectral
    purity against PSD masks."""

    _PI = float(np.pi)
    _MIX = {  # id → (mode, phase, frequency)
        "nco_0": ("nco", 0.0, 0.0), "nco_1": ("nco", 1.234, 0.0),
        "nco_2": ("nco", -1.234, 0.0), "nco_3": ("nco", 99.0, 0.0),
        "nco_4": ("nco", _PI, 0.0), "nco_5": ("nco", 0.0, _PI),
        "nco_6": ("nco", 0.0, -_PI), "nco_7": ("nco", 0.0, 0.123),
        "nco_8": ("nco", 0.0, -0.123), "nco_9": ("nco", 0.0, 1e-5),
        "vco_0": ("vco", 0.0, 0.0), "vco_1": ("vco", 1.234, 0.0),
        "vco_2": ("vco", -1.234, 0.0), "vco_3": ("vco", 99.0, 0.0),
        "vco_4": ("vco", _PI, 0.0), "vco_5": ("vco", 0.0, _PI),
        "vco_6": ("vco", 0.0, -_PI), "vco_7": ("vco", 0.0, 0.123),
        "vco_8": ("vco", 0.0, -0.123), "vco_9": ("vco", 0.0, 1e-5),
    }

    @autotest(param_map={f"[{k}]": f"nco_crcf_mix_{k}" for k in _MIX})
    @pytest.mark.parametrize("case", sorted(_MIX))
    def test_mix(self, case):
        mode, phase, freq = self._MIX[case]
        tol, n = 1e-2, 1200
        rng = np.random.default_rng(hash(case) % (1 << 31))
        x = np.exp(2j * np.pi * rng.random(n)).astype(np.complex64)
        osc = Osc.create(mode).set_phase(phase).set_frequency(freq)
        y, osc = osc.mix_block_up(jnp.asarray(x))
        y = np.asarray(y)
        theta = phase
        want = np.empty(n, np.complex64)
        for i in range(n):
            want[i] = x[i] * np.exp(1j * theta)
            theta += freq
            while theta > np.pi:
                theta -= 2 * np.pi
            while theta < -np.pi:
                theta += 2 * np.pi
        np.testing.assert_allclose(y.real, want.real, atol=tol)
        np.testing.assert_allclose(y.imag, want.imag, atol=tol)

    _SPEC = {"f00": 0.0, "f01": 0.1234, "f02": -0.1234, "f03": 0.25,
             "f04": 0.1}

    @autotest(param_map={f"[f0{i}-{m}]": f"nco_crcf_spectrum_{m}_f0{i}"
                         for m in ("nco", "vco") for i in range(5)})
    @pytest.mark.parametrize("mode", ["nco", "vco"])
    @pytest.mark.parametrize("case", sorted(_SPEC))
    def test_spectrum(self, mode, case):
        """Oscillator PSD: single tone ≤0 dB peak, ≤−60 dB elsewhere
        (osc.rs:648-684; shortened run, same masks)."""
        from yagi_tpu import fft as yfft
        from yagi_tpu.math.windows import WindowType, hann
        from yagi_tpu.utils import PsdRegion, validate_psd_spgram

        freq = self._SPEC[case]
        nfft = 9600
        osc = Osc.create(mode).set_frequency(2.0 * np.pi * freq)
        sp = yfft.Spgram.create(nfft, WindowType.BLACKMAN_HARRIS, nfft, nfft // 2)
        buf_len = 3 * nfft
        x = jnp.full(buf_len, 1.0 / np.sqrt(nfft), dtype=jnp.complex64)
        first = True
        while int(sp.num_samples_total) < (1 << 16):
            y, osc = osc.mix_block_up(x)
            if first:
                y = y * jnp.asarray(
                    np.asarray(hann(2 * buf_len))[:buf_len], dtype=jnp.float32
                )
                first = False
            sp = sp.write(y)
        regions = [
            PsdRegion(-0.5, freq - 0.002, 0.0, -60.0, False, True),
            PsdRegion(freq - 0.002, freq + 0.002, 0.0, 0.0, False, True),
            PsdRegion(freq + 0.002, 0.5, 0.0, -60.0, False, True),
        ]
        assert validate_psd_spgram(sp, regions), (mode, case)
