"""Log-depth parallel IIR path (filter/_linrec.py) vs the sequential scan.

Oracle: IirFilter.execute_block's lax.scan realization, itself golden-tested
against the reference recurrences (iirfilt.rs:359-383). The parallel path
runs the same recurrence with a different summation order, so parity is
fp32-tolerance-bounded; state carry must preserve block-split invariance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from yagi_tpu.filter import IirFilter


def _rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-12)


@pytest.mark.slow
class TestParallelIir:
    @pytest.mark.parametrize("order", [1, 2, 5, 8])
    def test_tf_form_parity(self, order):
        rng = np.random.default_rng(order)
        b = rng.standard_normal(order + 1) * 0.3
        # stable poles well inside the unit circle
        poles = 0.6 * rng.standard_normal(order) / max(order, 1)
        a = np.poly(poles) if order else np.array([1.0])
        f_seq = IirFilter.create(b, a, batch_shape=(3,))
        f_par = f_seq.parallelize()
        x = rng.standard_normal((3, 512)).astype(np.float32)
        y_seq, f_seq = f_seq.execute_block(jnp.asarray(x))
        y_par, f_par = f_par.execute_block(jnp.asarray(x))
        assert _rel(y_seq, y_par) < 2e-5
        # carried state equal too (second block stays in parity)
        x2 = rng.standard_normal((3, 512)).astype(np.float32)
        y2s, _ = f_seq.execute_block(jnp.asarray(x2))
        y2p, _ = f_par.execute_block(jnp.asarray(x2))
        assert _rel(y2s, y2p) < 2e-5

    def test_sos_butter_parity(self):
        rng = np.random.default_rng(1)
        f_seq = IirFilter.create_lowpass(7, 0.1, batch_shape=(2,))
        f_par = f_seq.parallelize()
        x = rng.standard_normal((2, 1024)).astype(np.float32)
        y_seq, _ = f_seq.execute_block(jnp.asarray(x))
        y_par, _ = f_par.execute_block(jnp.asarray(x))
        assert _rel(y_seq, y_par) < 1e-4

    def test_single_pole_deemphasis_parity(self):
        alpha = 0.05
        f_seq = IirFilter.create([alpha], [1.0, -(1.0 - alpha)], batch_shape=(4,))
        f_par = f_seq.parallelize()
        rng = np.random.default_rng(2)
        x = rng.standard_normal((4, 2048)).astype(np.float32)
        y_seq, _ = f_seq.execute_block(jnp.asarray(x))
        y_par, _ = f_par.execute_block(jnp.asarray(x))
        assert _rel(y_seq, y_par) < 2e-5

    def test_block_split_invariance(self):
        f = IirFilter.create_lowpass(5, 0.2).parallelize()
        rng = np.random.default_rng(3)
        x = rng.standard_normal(1024).astype(np.float32)
        y_all, _ = f.execute_block(jnp.asarray(x))
        y_a, f2 = f.execute_block(jnp.asarray(x[:512]))
        y_b, _ = f2.execute_block(jnp.asarray(x[512:]))
        y_cat = np.concatenate([np.asarray(y_a), np.asarray(y_b)])
        assert _rel(y_all, y_cat) < 1e-5

    def test_complex_signal(self):
        f = IirFilter.create_dc_blocker(
            0.1, batch_shape=(2,), dtype=jnp.complex64
        ).parallelize()
        f_seq = IirFilter.create_dc_blocker(0.1, batch_shape=(2,), dtype=jnp.complex64)
        rng = np.random.default_rng(4)
        x = (rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256))).astype(
            np.complex64
        )
        y_par, _ = f.execute_block(jnp.asarray(x))
        y_seq, _ = f_seq.execute_block(jnp.asarray(x))
        assert _rel(y_seq, y_par) < 2e-5

    def test_biquad_sos_parity(self):
        from yagi_tpu.filter import IirFilterSos

        f_seq = IirFilterSos.create(
            [0.2, 0.3, 0.1], [1.0, -0.5, 0.2], batch_shape=(3,)
        )
        f_par = f_seq.parallelize()
        rng = np.random.default_rng(6)
        x = rng.standard_normal((3, 777)).astype(np.float32)
        y_seq, f_seq = f_seq.execute_block(jnp.asarray(x))
        y_par, f_par = f_par.execute_block(jnp.asarray(x))
        assert _rel(y_seq, y_par) < 2e-5
        y2s, _ = f_seq.execute_block(jnp.asarray(x))
        y2p, _ = f_par.execute_block(jnp.asarray(x))
        assert _rel(y2s, y2p) < 2e-5

    def test_composite_passthrough(self):
        """IirHilb/IirDecim/IirInterp .parallelize() matches sequential."""
        from yagi_tpu.filter import (
            IirDecimationFilter,
            IirHilbertFilter,
            IirInterpolationFilter,
        )

        rng = np.random.default_rng(7)
        x = jnp.asarray(rng.standard_normal(512).astype(np.float32))
        for mk, run in [
            (lambda: IirHilbertFilter.create_default(5),
             lambda f, v: f.decim_execute_block(v)),
            (lambda: IirDecimationFilter.create_default(4, 5),
             lambda f, v: f.execute_block(v)),
            (lambda: IirInterpolationFilter.create_default(4, 5),
             lambda f, v: f.execute_block(v)),
        ]:
            a, _ = run(mk(), x)
            b, _ = run(mk().parallelize(), x)
            assert _rel(a, b) < 2e-5

    def test_integrator_tf8(self):
        """8th-order Pintelon-Schoukens integrator (SOS form) in parallel."""
        f_seq = IirFilter.create_integrator()
        f_par = f_seq.parallelize()
        rng = np.random.default_rng(5)
        x = rng.standard_normal(512).astype(np.float32)
        y_seq, _ = f_seq.execute_block(jnp.asarray(x))
        y_par, _ = f_par.execute_block(jnp.asarray(x))
        assert _rel(y_seq, y_par) < 1e-4

    def test_biquad_poles_at_0p99_parity(self):
        """Near-unit-circle poles (r=0.99): parallel companion path stays
        within fp32 tolerance of the sequential scan (filter/_linrec.py
        numerical-guard note)."""
        r, w = 0.99, 0.3
        a = np.array([1.0, -2 * r * np.cos(w), r * r], dtype=np.float32)
        b = np.array([1.0, 0.0, 0.0], dtype=np.float32)
        f_seq = IirFilter.create(b, a)
        f_par = f_seq.parallelize()
        rng = np.random.default_rng(9)
        x = rng.standard_normal(4096).astype(np.float32)
        y_seq, _ = f_seq.execute_block(jnp.asarray(x))
        y_par, _ = f_par.execute_block(jnp.asarray(x))
        assert _rel(y_seq, y_par) < 5e-4
