"""Fused chain kernel (kernels/chain.py) + planar boundary utilities.

Parity oracle: the two-stage XLA chain (chains/rx.py), itself golden-tested
against the reference semantics (firfilt.rs / resamp.rs / osc.rs). The fused
kernel collapses FIR ⊛ polyphase-branch filters into combined taps in f64, so
parity is tolerance-bounded (≲1e-4 rel) rather than bit-exact; the NCO phase
ramp is exact u32 and matches bit-for-bit.

On CPU the Triton kernel runs in Pallas interpret mode, by request; the
``gpu``-marked case and chip_smoke.py run it compiled on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yagi_tpu.chains import FusedRxChain, RxChain
from yagi_tpu.utils.planar import Planar, planar, planar_jit, planarize, unplanarize


def _rand_cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


class TestPlanar:
    def test_roundtrip_host(self):
        rng = np.random.default_rng(0)
        tree = {"a": _rand_cplx(rng, (3, 4)), "b": np.float32(2.0), "c": 1 + 2j}
        p = planarize(tree)
        assert isinstance(p["a"], Planar) and isinstance(p["c"], Planar)
        back = unplanarize(p)
        np.testing.assert_array_equal(back["a"], tree["a"])
        assert back["c"] == tree["c"]

    def test_planar_jit_boundary_real(self):
        rng = np.random.default_rng(1)
        x = _rand_cplx(rng, (2, 8))
        f = planar_jit(lambda v: v * (1 + 1j))
        out = f(planarize(x))
        assert isinstance(out, Planar)
        assert out.re.dtype == jnp.float32
        np.testing.assert_allclose(
            np.asarray(out.re) + 1j * np.asarray(out.im), x * (1 + 1j), rtol=1e-6
        )

    def test_planar_state_threading(self):
        """A stateful chain threads planar state across steps unchanged."""
        rng = np.random.default_rng(2)
        chain = RxChain.create(batch_shape=(2,))
        x = _rand_cplx(rng, (2, 512))
        y_ref, k_ref, c_ref = chain.step(jnp.asarray(x))
        pstep = planar_jit(lambda c, v: c.step(v))
        py, pk, pc = pstep(planarize(chain), planarize(jnp.asarray(x)))
        np.testing.assert_allclose(
            np.asarray(py.re) + 1j * np.asarray(py.im),
            np.asarray(y_ref),
            rtol=0,
            atol=1e-6,
        )
        # state leaves identical too
        y2_ref, _, _ = c_ref.step(jnp.asarray(x))
        py2, _, _ = pstep(pc, planarize(jnp.asarray(x)))
        np.testing.assert_allclose(
            np.asarray(py2.re) + 1j * np.asarray(py2.im),
            np.asarray(y2_ref),
            rtol=0,
            atol=1e-6,
        )


class TestFusedChain:
    @pytest.mark.parametrize("mix_freq", [0.0, 0.35])
    def test_parity_vs_xla_chain(self, mix_freq):
        C, T = 3, 2048
        ref = RxChain.create(mix_freq=mix_freq, batch_shape=(C,))
        fused = FusedRxChain.create(mix_freq=mix_freq, batch_shape=(C,),
                                    backend="triton", interpret=True)
        rng = np.random.default_rng(7)
        for blk in range(3):  # streaming state carry across blocks
            x = _rand_cplx(rng, (C, T))
            y, k, ref = ref.step(jnp.asarray(x))
            f, fk, fused = fused.step(jnp.asarray(x))
            assert int(k) == int(fk) == 2 * T
            a = np.asarray(y)[:, : int(k)]
            b = np.asarray(f)
            err = np.abs(a - b) / (np.abs(a) + 1e-3)
            assert err.max() < 1e-4, f"block {blk}: rel err {err.max()}"

    def test_block_split_invariance(self):
        """One 4096 block == two 2048 blocks (state carry exact)."""
        C = 2
        rng = np.random.default_rng(8)
        x = _rand_cplx(rng, (C, 4096))
        mk = lambda: FusedRxChain.create(  # noqa: E731
            batch_shape=(C,), backend="triton", interpret=True)
        c1 = mk()
        y_all, _, _ = c1.step(jnp.asarray(x))
        c2 = mk()
        y_a, _, c2 = c2.step(jnp.asarray(x[:, :2048]))
        y_b, _, c2 = c2.step(jnp.asarray(x[:, 2048:]))
        y_cat = np.concatenate([np.asarray(y_a), np.asarray(y_b)], axis=-1)
        np.testing.assert_allclose(np.asarray(y_all), y_cat, rtol=0, atol=1e-5)

    def test_planar_step_matches_complex_step(self):
        C, T = 2, 1024
        rng = np.random.default_rng(9)
        x = _rand_cplx(rng, (C, T))
        c = FusedRxChain.create(batch_shape=(C,), backend="triton",
                                interpret=True)
        y, k, _ = c.step(jnp.asarray(x))
        yr, yi, k2, _ = c.step_planar(
            jnp.asarray(np.ascontiguousarray(x.real)),
            jnp.asarray(np.ascontiguousarray(x.imag)),
        )
        np.testing.assert_array_equal(np.asarray(jnp.real(y)), np.asarray(yr))
        np.testing.assert_array_equal(np.asarray(jnp.imag(y)), np.asarray(yi))

    def test_rejects_bad_config(self):
        from yagi_tpu.errors import ConfigError

        with pytest.raises(ConfigError):
            FusedRxChain.create(rate=1.5, batch_shape=(2,))
        with pytest.raises(ConfigError):
            FusedRxChain.create(rate=3.0, batch_shape=(2,))  # 3 ∤ 2^24
        with pytest.raises(ConfigError):
            FusedRxChain.create(batch_shape=())
        with pytest.raises(ConfigError):
            FusedRxChain.create(batch_shape=(2,), backend="pallas")


def _chain_args(rng, C, T, p=2, k=77):
    from yagi_tpu.kernels.chain import HIST

    g = rng.standard_normal((k, p)).astype(np.float32)
    return (jnp.asarray(rng.standard_normal((C, T)).astype(np.float32)),
            jnp.asarray(rng.standard_normal((C, T)).astype(np.float32)),
            jnp.asarray(g),
            jnp.asarray(rng.standard_normal((C, HIST)).astype(np.float32)),
            jnp.asarray(rng.standard_normal((C, HIST)).astype(np.float32)),
            jnp.uint32(0x9E3779B9), jnp.uint32(0x12345678))


class TestChainKernelWrapper:
    """The kernel against its plain XLA formulation, and the wrapper's
    shape, tile, history and routing rules."""

    @pytest.mark.parametrize("p,T", [(1, 256), (2, 384), (4, 1024), (2, 2048)])
    def test_kernel_matches_reference(self, p, T):
        from yagi_tpu.kernels.chain import chain_reference, fused_chain_apply

        args = _chain_args(np.random.default_rng(p * T), 3, T, p=p)
        yr, yi = fused_chain_apply(*args, interpret=True)
        rr, ri = chain_reference(*args)
        assert yr.shape == (3, T * p)
        scale = float(np.abs(np.asarray(rr)).max())
        np.testing.assert_allclose(np.asarray(yr), np.asarray(rr),
                                   atol=2e-6 * scale)
        np.testing.assert_allclose(np.asarray(yi), np.asarray(ri),
                                   atol=2e-6 * scale)

    def test_history_feeds_first_tile(self):
        """Only the first tile reads the carried history."""
        from yagi_tpu.kernels.chain import fused_chain_apply

        args = list(_chain_args(np.random.default_rng(1), 2, 512))
        y0, _ = fused_chain_apply(*args, interpret=True)
        args[3] = args[3] * 0
        y1, _ = fused_chain_apply(*args, interpret=True)
        d = np.abs(np.asarray(y0) - np.asarray(y1)).max(axis=0)
        assert d[: 2 * 76].max() > 0  # first K-1 inputs see the history
        assert d[2 * 77:].max() == 0

    @pytest.mark.parametrize("t,k,tile", [
        (1 << 17, 77, 512), (1024, 77, 512), (384, 77, 128),
        (640, 77, 128), (256, 128, 256),
    ])
    def test_tile_choice(self, t, k, tile):
        from yagi_tpu.kernels.chain import chain_tile

        assert chain_tile(t, k) == tile

    @pytest.mark.parametrize("t", [0, 100, 64 + 128])
    def test_tile_rejects_unaligned_blocks(self, t):
        from yagi_tpu.kernels.chain import chain_tile

        with pytest.raises(ValueError):
            chain_tile(t, 77)

    def test_rejects_bad_history(self):
        from yagi_tpu.kernels.chain import fused_chain_apply

        args = list(_chain_args(np.random.default_rng(2), 2, 256))
        args[3] = args[3][:, :64]
        with pytest.raises(ValueError):
            fused_chain_apply(*args, interpret=True)

    def test_rejects_long_filters(self):
        from yagi_tpu.kernels.chain import chain_taps

        with pytest.raises(ValueError):
            chain_taps(np.ones(100), 1.0, np.ones((4, 40)), 2)

    def test_taps_are_tap_major(self):
        from yagi_tpu.kernels.chain import chain_taps

        rng = np.random.default_rng(3)
        h, br = rng.standard_normal(5), rng.standard_normal((4, 3))
        g = chain_taps(h, 0.5, br, 2)
        assert g.shape == (7, 2)
        np.testing.assert_allclose(g[:, 1], np.convolve(0.5 * h, br[2]),
                                   rtol=1e-6)

    def test_auto_route_on_cpu_is_xla(self, monkeypatch):
        """"auto" never takes the kernel off the GPU, and nothing runs the
        kernel in interpret mode unless asked."""
        import yagi_tpu.chains.fused as fused_mod

        def boom(*a, **k):
            raise AssertionError("kernel called")

        monkeypatch.setattr(fused_mod, "fused_chain_apply", boom)
        c = FusedRxChain.create(batch_shape=(2,))
        assert c.backend == "auto" and not c.interpret
        assert not c.uses_kernel(1024)
        y, k, _ = c.step(jnp.zeros((2, 1024), jnp.complex64))
        assert y.shape == (2, 2048)

    def test_explicit_route_takes_kernel(self, monkeypatch):
        import yagi_tpu.chains.fused as fused_mod

        seen = {}

        def spy(*a, interpret=False):
            seen["interpret"] = interpret
            return fused_mod.chain_reference(*a)

        monkeypatch.setattr(fused_mod, "fused_chain_apply", spy)
        c = FusedRxChain.create(batch_shape=(2,), backend="triton")
        c.step(jnp.zeros((2, 256), jnp.complex64))
        assert seen == {"interpret": False}
        # blocks the kernel cannot tile take the XLA route
        assert not c.uses_kernel(200)

    @pytest.mark.parametrize("backend", ["xla", "triton"])
    def test_short_blocks_carry_history(self, backend):
        """Blocks shorter than the history still stream exactly (XLA
        route), and the history stays [C, 128]."""
        C = 2
        rng = np.random.default_rng(4)
        x = _rand_cplx(rng, (C, 256))
        mk = lambda: FusedRxChain.create(  # noqa: E731
            batch_shape=(C,), backend=backend, interpret=True)
        y_all, _, _ = mk().step(jnp.asarray(x))
        c, parts = mk(), []
        for s in range(0, 256, 64):
            y, _, c = c.step(jnp.asarray(x[:, s:s + 64]))
            parts.append(np.asarray(y))
            assert c.hist_r.shape == (C, 128)
        np.testing.assert_allclose(np.concatenate(parts, -1),
                                   np.asarray(y_all), atol=1e-5)

    @pytest.mark.gpu
    def test_compiled_kernel_matches_reference(self, gpu):
        from yagi_tpu.kernels.chain import chain_reference, fused_chain_apply

        args = _chain_args(np.random.default_rng(5), 16, 1 << 17)
        yr, yi = fused_chain_apply(*args)
        rr, ri = chain_reference(*args)
        scale = float(np.abs(np.asarray(rr)).max())
        np.testing.assert_allclose(np.asarray(yr), np.asarray(rr),
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(np.asarray(yi), np.asarray(ri),
                                   atol=1e-5 * scale)
