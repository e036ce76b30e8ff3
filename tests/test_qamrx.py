"""QamRx chain (chains/qam.py) — the symtrack-style QAM receiver.

Fills the reference's 0-byte framing stub (src/framing/symtrack.rs) and
packages BASELINE config[3]. Oracle: transmit known 16-QAM over an impaired
channel, require zero tail symbol errors and low tail EVM after acquisition.
"""

import numpy as np

from tests.autotest import autotest
import pytest

import jax.numpy as jnp

from yagi_tpu.chains import QamRx
from yagi_tpu.design import FirFilterShape, fir_design_prototype
from yagi_tpu.errors import ConfigError
from yagi_tpu.filter import FirInterpolationFilter
from yagi_tpu.modem import Modem

K, M, BETA = 2, 7, 0.3
NSYM = 3000


def _tx(seed=42, nsym=NSYM):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 16, nsym).astype(np.uint32)
    modem = Modem.create("qam16")
    pts, _ = modem.modulate(jnp.asarray(syms))
    h = fir_design_prototype(FirFilterShape.RRCOS, K, M, BETA)
    interp = FirInterpolationFilter.create(K, h)
    sig, _ = interp.execute_block(pts)
    return syms, np.asarray(sig).astype(np.complex64), np.asarray(modem.table)


def _run(rx, sig, splits):
    soft_parts, sym_parts = [], []
    for blk in np.split(sig, splits):
        s, v, no, rx = rx.step(blk)
        nn = int(np.asarray(no))
        sym_parts.append(np.asarray(s)[:nn])
        soft_parts.append(np.asarray(v)[:nn])
    return np.concatenate(sym_parts), np.concatenate(soft_parts), rx


def _tail_ser(got, want):
    best = 1.0
    for off in range(40):
        L = min(len(got) - off, len(want))
        tl = slice(3 * L // 4, L)
        best = min(best, float(np.mean(got[off : off + L][tl] != want[:L][tl])))
    return best


class TestQamRx:
    @autotest("symtrack_cccf_qpsk", "symtrack_cccf_bpsk")
    def test_clean_convergence(self):
        syms_tx, sig, tab = _tx()
        rx = QamRx.create("rrcos", K, M, BETA, scheme="qam16")
        got, soft, rx = _run(rx, sig, 4)
        assert len(got) == NSYM
        ts = soft[-800:]
        evm = 10 * np.log10(np.mean(np.abs(ts[:, None] - tab).min(1) ** 2))
        assert evm < -35.0
        assert _tail_ser(got, syms_tx) == 0.0
        # no symsync emission was ever deferred past the 2-slot capacity
        assert int(np.asarray(rx.overflow_count)) == 0

    def test_impaired_channel(self):
        """config[3]: gain + phase offset + CFO + echo + noise."""
        syms_tx, sig, tab = _tx()
        rng = np.random.default_rng(3)
        n = len(sig)
        s = sig + 0.1 * np.roll(sig, 3) * np.exp(1j * 1.1)
        s = 0.5 * s * np.exp(1j * (0.3 + 1e-4 * np.arange(n)))
        s = (s + (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.002).astype(
            np.complex64
        )
        rx = QamRx.create("rrcos", K, M, BETA, scheme="qam16")
        got, soft, rx = _run(rx, s, 4)
        ts = soft[-800:]
        evm = 10 * np.log10(np.mean(np.abs(ts[:, None] - tab).min(1) ** 2))
        assert evm < -25.0
        assert _tail_ser(got, syms_tx) == 0.0
        # carrier loop actually acquired the offset
        assert abs(float(np.asarray(rx.theta)) % (2 * np.pi)) > 0.05
        # impairments never pushed the timing loop past the 2-slot capacity
        assert int(np.asarray(rx.overflow_count)) == 0

    @pytest.mark.slow
    def test_block_split_invariance(self):
        _, sig, _ = _tx(seed=7, nsym=1200)
        rx1 = QamRx.create("rrcos", K, M, BETA, scheme="qam16")
        g1, s1, _ = _run(rx1, sig, 1)
        rx2 = QamRx.create("rrcos", K, M, BETA, scheme="qam16")
        g2, s2, _ = _run(rx2, sig, [101, 1000, 1003])
        assert len(g1) == len(g2)
        np.testing.assert_array_equal(g1, g2)
        np.testing.assert_allclose(s1, s2, rtol=2e-4, atol=2e-4)

    @autotest("symtrack_cccf_config_valid")
    def test_evm_reporting(self):
        _, sig, _ = _tx(seed=9, nsym=1500)
        rx = QamRx.create("rrcos", K, M, BETA, scheme="qam16")
        _, _, rx = _run(rx, sig, 2)
        evm = float(np.asarray(rx.get_evm()))
        assert evm < -20.0
        rx = rx.reset()
        assert float(np.asarray(rx.evm_count)) == 0.0

    @autotest("symtrack_cccf_config_invalid")
    def test_invalid(self):
        with pytest.raises(ConfigError):
            QamRx.create("rrcos", 1, M, BETA)
        with pytest.raises(ConfigError):
            QamRx.create("rrcos", K, M, 1.5)
        with pytest.raises(ConfigError):
            QamRx.create("rrcos", K, M, BETA, eq_len=6)
        with pytest.raises(ConfigError):
            QamRx.create("rrcos", K, M, BETA).set_bandwidth(-0.1)


class TestDecoupledPath:
    def test_decoupled_matches_joint(self):
        """The decoupled formulation (symsync kernel + eq-only scan; the
        kernel interpreted here) must match the joint fused scan: same
        mask, same symbols, soft values within float tolerance."""
        import jax.numpy as jnp

        rng = np.random.default_rng(9)
        C, n = 8, 512
        x = (rng.standard_normal((C, n)) + 1j * rng.standard_normal((C, n))
             ).astype(np.complex64) * 0.5
        rx = QamRx.create(batch_shape=(C,))
        s1, soft1, m1, n1 = rx.step_masked(jnp.asarray(x))
        s2, soft2, m2, n2 = rx._step_masked_decoupled(jnp.asarray(x),
                                                      interpret=True)
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
        np.testing.assert_array_equal(np.asarray(s1)[np.asarray(m1)],
                                      np.asarray(s2)[np.asarray(m2)])
        d = np.abs(np.asarray(soft1) - np.asarray(soft2)).max()
        assert d < 1e-5, d
        np.testing.assert_allclose(np.asarray(n1.theta),
                                   np.asarray(n2.theta), atol=1e-5)
        np.testing.assert_allclose(np.asarray(n1.eq.w),
                                   np.asarray(n2.eq.w), atol=1e-5)
