"""Symsync loop kernel (kernels/symscan.py) — interpret-mode parity.

The Triton kernel runs the whole control loop per channel block and forms
only the selected branch's dots; against the XLA lax.scan formulation
(filter/symsync.execute_slots backend="xla") it must give the same
emissions, the same values and the same carried state — including
valid-prefix streaming and block splits. On the CPU interpreter both sum in
the same order, so parity here is bit-exact; on the card the dot order
differs and chip_smoke.py holds the two to a tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from yagi_tpu.design import FirFilterShape
from yagi_tpu.filter import Symsync

from autotest import autotest

C, N = 128, 256


def _mk():
    return Symsync.create_rnyquist(
        FirFilterShape.RRCOS, 2, 7, 0.3, batch_shape=(C,)
    ).set_lf_bw(0.02)


def _sig(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, n)) + 1j * rng.standard_normal((C, n))
            ).astype(np.complex64)


class TestSymscanKernel:
    @autotest("symsync_crcf_scenario_0")
    @pytest.mark.slow
    def test_bit_exact_vs_xla(self):
        x = _sig()
        ya, va, sa = _mk().execute_slots(jnp.asarray(x), backend="xla")
        yb, vb, sb = _mk().execute_slots(jnp.asarray(x), backend="triton", interpret=True)
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
        for fa, fb in zip(jax.tree_util.tree_leaves(sa),
                          jax.tree_util.tree_leaves(sb)):
            np.testing.assert_allclose(
                np.asarray(fa), np.asarray(fb), rtol=1e-6, atol=1e-6
            )

    def test_n_valid_parity(self):
        x = _sig(seed=1)
        ya, va, _ = _mk().execute_slots(jnp.asarray(x), n_valid=200,
                                        backend="xla")
        yb, vb, _ = _mk().execute_slots(jnp.asarray(x), n_valid=200,
                                        backend="triton", interpret=True)
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))

    @pytest.mark.slow
    def test_block_split_invariance(self):
        x = _sig(seed=2)
        s = _mk()
        y1, v1, s = s.execute_slots(jnp.asarray(x[:, :128]), backend="triton", interpret=True)
        y2, v2, s = s.execute_slots(jnp.asarray(x[:, 128:]), backend="triton", interpret=True)
        yf, vf, _ = _mk().execute_slots(jnp.asarray(x), backend="triton", interpret=True)
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(v1), np.asarray(v2)], axis=1),
            np.asarray(vf),
        )
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(y1), np.asarray(y2)], axis=1),
            np.asarray(yf),
        )

    def test_unsupported_shapes_fall_back(self, monkeypatch):
        # a 2-D batch is not a kernel shape: backend="triton" falls back to
        # the XLA scan, which must still serve it
        import yagi_tpu.kernels.symscan as ks

        monkeypatch.setattr(ks, "symsync_scan", None)
        ss = Symsync.create_rnyquist(
            FirFilterShape.RRCOS, 2, 7, 0.3, batch_shape=(2, 3)
        )
        x = (np.random.default_rng(3).standard_normal((2, 3, 64))
             + 0j).astype(np.complex64)
        y, v, _ = ss.execute_slots(jnp.asarray(x), backend="triton")
        assert y.shape[:3] == (2, 3, 64)


class TestSymscanFused:
    """The kernel's in-kernel matched-filter dots against the XLA banded
    matmul at tolerance level (the bound the card is held to); the
    kernel's own block-split invariance and the emission schedule must
    stay exact."""

    def test_tolerance_parity_vs_xla(self):
        x = _sig(seed=3)
        ya, va, sa = _mk().execute_slots(jnp.asarray(x), backend="xla")
        yb, vb, sb = _mk().execute_slots(jnp.asarray(x), backend="triton", interpret=True)
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        d = np.abs(np.asarray(ya) - np.asarray(yb))
        ref = np.abs(np.asarray(ya)).max()
        assert d.max() < 1e-4 * max(ref, 1.0), d.max()
        np.testing.assert_allclose(
            np.asarray(sa.tau), np.asarray(sb.tau), atol=1e-4
        )

    def test_n_valid_parity(self):
        x = _sig(seed=4)
        ya, va, _ = _mk().execute_slots(jnp.asarray(x), n_valid=200,
                                        backend="xla")
        yb, vb, _ = _mk().execute_slots(jnp.asarray(x), n_valid=200,
                                        backend="triton", interpret=True)
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        assert np.abs(np.asarray(ya) - np.asarray(yb)).max() < 1e-4

    @pytest.mark.slow
    def test_block_split_invariance_bit_exact(self):
        """Against ITSELF the fused kernel is bit-invariant to splits."""
        x = _sig(seed=5)
        s = _mk()
        y1, v1, s = s.execute_slots(jnp.asarray(x[:, :128]), backend="triton", interpret=True)
        y2, v2, s = s.execute_slots(jnp.asarray(x[:, 128:]), backend="triton", interpret=True)
        yf, vf, _ = _mk().execute_slots(jnp.asarray(x), backend="triton", interpret=True)
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(v1), np.asarray(v2)], axis=1),
            np.asarray(vf),
        )
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(y1), np.asarray(y2)], axis=1),
            np.asarray(yf),
        )


class TestLaneMisalignedPad:
    """Batches that do not fill whole programs ride the kernel via an
    edge-pad of the channel axis + slice (kernels/symscan.symsync_scan):
    results must be BIT-EXACT vs the XLA scan at the original C — the pad
    channels are independent, so they cannot perturb the real channels."""

    @pytest.mark.parametrize("c", [8, 64, 100])
    def test_pad_path_bit_exact(self, c):
        rng = np.random.default_rng(6)
        x = (rng.standard_normal((c, N)) + 1j *
             rng.standard_normal((c, N))).astype(np.complex64)
        mk = lambda: Symsync.create_rnyquist(  # noqa: E731
            FirFilterShape.RRCOS, 2, 7, 0.3, batch_shape=(c,)
        ).set_lf_bw(0.02)
        ya, va, sa = mk().execute_slots(jnp.asarray(x), backend="xla")
        yb, vb, sb = mk().execute_slots(jnp.asarray(x), backend="triton", interpret=True)
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
        assert np.asarray(vb).shape[0] == c
        for fa, fb in zip(jax.tree_util.tree_leaves(sa),
                          jax.tree_util.tree_leaves(sb)):
            assert np.asarray(fa).shape == np.asarray(fb).shape
            np.testing.assert_allclose(
                np.asarray(fa), np.asarray(fb), rtol=1e-6, atol=1e-6)

    def test_pad_path_fused_matches_unpadded_kernel(self):
        """C=100 run 16 channels per program (padded to 112) equals the
        one-channel-per-program run (pad transparency)."""
        from yagi_tpu.kernels.symscan import symsync_scan

        c, n = 100, 64
        ss = Symsync.create_rnyquist(
            FirFilterShape.RRCOS, 2, 7, 0.3, batch_shape=(c,))
        L = ss.mf.shape[1]
        rng = np.random.default_rng(7)
        xr = jnp.asarray(rng.standard_normal((c, L + n)).astype(np.float32))
        xi = jnp.asarray(rng.standard_normal((c, L + n)).astype(np.float32))
        bank = jnp.concatenate([ss.mf, ss.dmf])
        state = jnp.zeros((9, c), jnp.float32).at[4:6].set(2.0)
        consts = jnp.zeros((5, c), jnp.float32).at[4].set(0.5)
        outs = [symsync_scan(xr, xi, n, bank, state, consts, P=32, E=2,
                             k_out=1, bc=bc, interpret=True) for bc in (1, 16)]
        assert outs[1][0].shape == (n, 6, c) and outs[1][1].shape == (9, c)
        for a, b in zip(*outs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestSymscanRouting:
    """Route choice, the shape predicate and the kernel's helpers."""

    def test_auto_on_cpu_is_xla(self, monkeypatch):
        import yagi_tpu.kernels.symscan as ks

        monkeypatch.setattr(ks, "symsync_scan", None)  # must not be reached
        y, v, _ = _mk().execute_slots(jnp.asarray(_sig(n=32)))
        assert y.shape == (C, 32, 2)

    def test_interpret_only_on_request(self, monkeypatch):
        import yagi_tpu.kernels.symscan as ks

        seen = []
        real = ks.symsync_scan

        def spy(*a, **k):
            seen.append(k["interpret"])
            return real(*a, **{**k, "interpret": True})

        monkeypatch.setattr(ks, "symsync_scan", spy)
        _mk().execute_slots(jnp.asarray(_sig(n=16)), backend="triton")
        _mk().execute_slots(jnp.asarray(_sig(n=16)), backend="triton",
                            interpret=True)
        assert seen == [False, True]

    def test_unknown_backend_raises(self):
        from yagi_tpu.errors import ConfigError

        for name in ("pallas", "fused", "mosaic"):
            with pytest.raises(ConfigError):
                _mk().execute_slots(jnp.asarray(_sig(n=16)), backend=name)

    def test_packed_steps_take_xla(self, monkeypatch):
        import yagi_tpu.kernels.symscan as ks

        monkeypatch.setattr(ks, "symsync_scan", None)
        y, _, _ = _mk().execute_slots(jnp.asarray(_sig(n=32)),
                                      samples_per_step=4, backend="triton")
        assert y.shape == (C, 32, 2)

    @pytest.mark.parametrize("shape,taps,ok", [
        ((1024,), 28, True), ((3,), 28, True), ((2, 3), 28, False),
        ((), 28, False), ((8,), 65, False), ((0,), 28, False),
    ])
    def test_supported(self, shape, taps, ok):
        from yagi_tpu.kernels.symscan import supported

        assert supported(shape, taps) is ok

    @pytest.mark.parametrize("c,bc", [
        (1, 1), (255, 1), (1023, 1), (1024, 2), (2047, 2), (2048, 4),
        (4096, 4), (1 << 20, 4),
    ])
    def test_channel_block(self, c, bc):
        from yagi_tpu.kernels.symscan import channel_block

        assert channel_block(c) == bc

    def test_round_half_even(self):
        from yagi_tpu.kernels.symscan import _round_half_even

        v = jnp.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.49, 3.51, 7.0,
                         -0.2, 30.5, 31.5], jnp.float32)
        np.testing.assert_array_equal(np.asarray(_round_half_even(v)),
                                      np.asarray(jnp.round(v)))

    def test_rejects_bad_bank(self):
        from yagi_tpu.kernels.symscan import symsync_scan

        z = jnp.zeros((2, 70), jnp.float32)
        with pytest.raises(ValueError):
            symsync_scan(z, z, 4, jnp.zeros((64, 65)), jnp.zeros((9, 2)),
                         jnp.zeros((5, 2)), P=32, E=2, k_out=1, interpret=True)
        with pytest.raises(ValueError):
            symsync_scan(z, z, 4, jnp.zeros((60, 28)), jnp.zeros((9, 2)),
                         jnp.zeros((5, 2)), P=32, E=2, k_out=1, interpret=True)

    def test_qamrx_kernel_route_matches_joint(self):
        from yagi_tpu.chains import QamRx

        rng = np.random.default_rng(11)
        x = (rng.standard_normal((5, 256)) + 1j * rng.standard_normal((5, 256))
             ).astype(np.complex64) * 0.5
        rx = QamRx.create(batch_shape=(5,))
        s1, f1, m1, n1 = rx.step_masked(jnp.asarray(x), backend="xla")
        s2, f2, m2, n2 = rx.step_masked(jnp.asarray(x), backend="triton",
                                        interpret=True)
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
        assert np.abs(np.asarray(f1) - np.asarray(f2)).max() < 1e-5

    @pytest.mark.gpu
    def test_compiled_kernel_matches_xla(self, gpu):
        """Compiled on the card, the kernel agrees with the XLA scan from
        the stream start until a float-order difference flips one
        branch-index rounding (the check chip_smoke.py config[1] makes)."""
        import chip_smoke

        qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4)))
        x = chip_smoke.linear_signal(jax, np.random.default_rng(12), qpsk, C,
                                     4096, 2.0)
        ya, va, _ = _mk().execute_slots(jnp.asarray(x), backend="xla")
        yb, vb, _ = _mk().execute_slots(jnp.asarray(x), backend="triton")
        t = chip_smoke.Tracks("kernel vs xla", C, 1e-3, 4096 // 8)
        t.update(vb, va, yb, ya)
        t.report()
