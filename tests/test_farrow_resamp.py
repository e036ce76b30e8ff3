"""Arbitrary-rate Farrow fast path (filter/_farrow_resamp.py).

The gather-free fast path for truly-arbitrary rates: prototype-FIR on a 2x
half-integer grid + LS-designed polynomial interpolator evaluated at the
exact u32 emission times. The emission SCHEDULE (counts, carried phase,
window state) is bit-identical to the reference u32 gather path; VALUES
agree within the reference's own 1/256 branch-quantization floor
(resamp.rs:141-154 truncates the fractional phase to 256 branch offsets,
~ -45 dB; the farrow design error is <= -55 dB over every legal fc).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from yagi_tpu.errors import ConfigError
from yagi_tpu.filter import MsResamp, Resamp
from yagi_tpu.filter._farrow_resamp import farrow_design_error_db

from autotest import autotest

RATES = [0.7153]
RATES_SLOW = [0.37, 1.31719, 2.0013, 0.9871, 3.14159]


def _bandlimited(n, seed=0, fmax=0.23):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    fs = np.linspace(0.01, fmax, 6)
    return (sum(np.exp(2j * np.pi * (f * t + rng.random())) for f in fs)
            / len(fs)).astype(np.complex64)


def _snr_db(ref, got):
    err = ref - got
    return 10 * np.log10(
        np.mean(np.abs(ref) ** 2) / max(np.mean(np.abs(err) ** 2), 1e-30)
    )


class TestFarrowResamp:
    def test_design_error_below_branch_floor(self):
        # the interpolator must sit below the reference's own -45 dB
        # 1/256-branch rounding floor over the half-grid band
        assert farrow_design_error_db() < -50.0

    @pytest.mark.parametrize(
        "rate", RATES + [pytest.param(r, marks=pytest.mark.slow)
                         for r in RATES_SLOW])
    @autotest("resamp_crcf_00")
    def test_schedule_bit_identical_values_close(self, rate):
        """Counts, phase, and window state match the u32 path exactly;
        values within the quantization floor."""
        x = _bandlimited(4096, seed=int(rate * 100))
        ra = Resamp.create(rate)
        rb = Resamp.create(rate, interp="farrow")
        ya, na, ra2 = ra.execute_block(jnp.asarray(x))
        yb, nb, rb2 = rb.execute_block(jnp.asarray(x))
        assert int(na) == int(nb)
        assert int(np.asarray(ra2.phase)) == int(np.asarray(rb2.phase))
        np.testing.assert_array_equal(
            np.asarray(ra2.window), np.asarray(rb2.window)
        )
        na = int(na)
        # full valid range (only the leading filter transient excluded):
        # aggregate SNR plus a per-sample cap, so a few zeroed/corrupt
        # samples cannot hide in the average
        ref = np.asarray(ya)[:na]
        got = np.asarray(yb)[:na]
        snr = _snr_db(ref[64:], got[64:])
        assert snr > 45.0, snr
        err = np.abs(ref[64:] - got[64:])
        assert err.max() < 0.03 * np.abs(ref).max(), err.max()

    @pytest.mark.slow
    def test_block_split_tolerance(self):
        """Split-invariant within the interpolation tolerance: boundary
        emissions use the exact reference dotprod (no future inputs), so
        the two runs differ only at the quantization-noise level."""
        x = _bandlimited(8192, seed=3)
        rb = MsResamp.create(0.7153, arbitrary_interp="farrow").arbitrary
        y1, n1, rb = rb.execute_block(jnp.asarray(x[:4096]))
        y2, n2, rb = rb.execute_block(jnp.asarray(x[4096:]))
        split = np.concatenate(
            [np.asarray(y1)[: int(n1)], np.asarray(y2)[: int(n2)]]
        )
        rc = Resamp.create(0.7153, fc=rb.fc, interp="farrow")
        yc, nc, _ = rc.execute_block(jnp.asarray(x))
        whole = np.asarray(yc)[: int(nc)]
        assert len(split) == len(whole)
        assert _snr_db(whole, split) > 40.0

    @pytest.mark.slow
    def test_high_cutoff(self):
        """MsResamp's arbitrary stage runs fc up to 0.49 — the 2x grid
        keeps the farrow band ≤ 0.25 so accuracy holds."""
        x = _bandlimited(4096, seed=5, fmax=0.42)
        ra = Resamp.create(0.93, fc=0.47)
        rb = Resamp.create(0.93, fc=0.47, interp="farrow")
        ya, na, _ = ra.execute_block(jnp.asarray(x))
        yb, nb, _ = rb.execute_block(jnp.asarray(x))
        na = int(na)
        ref = np.asarray(ya)[64:na]
        got = np.asarray(yb)[64:na]
        snr = _snr_db(ref, got)
        assert snr > 42.0, snr
        assert np.abs(ref - got).max() < 0.04 * np.abs(ref).max()

    @pytest.mark.parametrize("rate", [0.9871,
        pytest.param(0.37, marks=pytest.mark.slow),
        pytest.param(2.5, marks=pytest.mark.slow)])
    @autotest("msresamp_crcf_01")
    def test_msresamp_farrow(self, rate):
        """Full composite resampler with the farrow arbitrary stage."""
        x = _bandlimited(4096, seed=int(rate * 7), fmax=0.2)
        ma = MsResamp.create(rate)
        mb = MsResamp.create(rate, arbitrary_interp="farrow")
        ya, na, _ = ma.execute_block(jnp.asarray(x))
        yb, nb, _ = mb.execute_block(jnp.asarray(x))
        assert int(na) == int(nb)
        na = int(na)
        if na > 200:
            ref = np.asarray(ya)[80:na]
            got = np.asarray(yb)[80:na]
            snr = _snr_db(ref, got)
            assert snr > 40.0, snr
            assert np.abs(ref - got).max() < 0.05 * np.abs(ref).max()

    def test_invalid_interp(self):
        with pytest.raises(ConfigError):
            Resamp.create(0.7, interp="nope")

    def test_reset_recertifies_fast_path(self):
        """reset() after a traced set_rate must restore BOTH the static
        schedule and the farrow step certificate (a step_cert left at None
        would silently disable the fast path forever)."""
        r = Resamp.create(2.0, interp="farrow")
        nominal_cert = r.step_cert
        assert nominal_cert is not None
        r2 = jax.jit(lambda s, g: s.adjust_rate(g))(r, jnp.float32(1.0))
        assert r2.step_cert is None
        r3 = r2.reset()
        assert r3.step_cert == nominal_cert
        assert r3.exact_sched == r.exact_sched

    @pytest.mark.parametrize("rate", [0.37,
        pytest.param(1.234, marks=pytest.mark.slow)])
    def test_tail_full_range_any_capacity(self, rate):
        """Every valid emission — including the block tail, and with an
        oversized output capacity — matches the u32 path per-sample.

        Regression: the exact-dotprod tail window was once
        anchored to out_capacity instead of the emission schedule, so any
        capacity slack beyond ~rate+2 slots silently zeroed valid tail
        emissions."""
        n = 2048
        x = _bandlimited(n, seed=11)
        for cap in (None, int(np.ceil(n * rate)) + 552):
            ra = Resamp.create(rate)
            rb = Resamp.create(rate, interp="farrow")
            kw = {} if cap is None else {"out_capacity": cap}
            ya, na, _ = ra.execute_block(jnp.asarray(x), **kw)
            yb, nb, _ = rb.execute_block(jnp.asarray(x), **kw)
            na = int(na)
            assert na == int(nb)
            ref = np.asarray(ya)[:na]
            got = np.asarray(yb)[:na]
            err = np.abs(ref[64:] - got[64:])
            assert err.max() < 0.03 * np.abs(ref).max(), (
                cap, float(err.max()), int(np.argmax(err)) + 64, na,
            )

    def test_farrow_under_jit_streaming(self):
        """The fast path must stay active under jit with threaded state
        (the step certificate is a static pytree field) — and every block's
        values must match the u32 path over the FULL block, including the
        slots near the oversized capacity's tail."""
        x = _bandlimited(2048, seed=9)
        ra = Resamp.create(1.234)
        rb = Resamp.create(1.234, interp="farrow")
        step = jax.jit(lambda s, v: s.execute_block(v, out_capacity=2600))
        tot = 0
        outs_a, outs_b = [], []
        for k in range(3):
            ya, na, ra = step(ra, jnp.asarray(x))
            yb, nb, rb = step(rb, jnp.asarray(x))
            assert int(na) == int(nb)
            outs_a.append(np.asarray(ya)[: int(na)])
            outs_b.append(np.asarray(yb)[: int(nb)])
            tot += int(nb)
        assert tot == Resamp.create(1.234).get_num_output(3 * 2048)
        ref = np.concatenate(outs_a)
        got = np.concatenate(outs_b)
        err = np.abs(ref[64:] - got[64:])
        assert err.max() < 0.03 * np.abs(ref).max(), float(err.max())
