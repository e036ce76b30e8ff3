"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Core product guarantee (BASELINE.json north star): block-processed output
under time/channel sharding is bit-for-block identical to the same block
computation on one device.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from yagi_tpu.filter import FirFilter
from yagi_tpu.parallel import make_stream_mesh, time_sharded_fir


def _device_fm(y, kf):
    """The sharded paths' elementwise FM discriminator, on one device —
    lets the FM comparisons be exact instead of tolerance-based. ``ref``
    is computed host-side in f64 exactly as parallel/channelizer.py does."""
    ref = 1.0 / (2.0 * np.pi * kf)
    return jax.jit(
        lambda v: jnp.angle(jnp.conj(v[..., :-1]) * v[..., 1:])
        * jnp.float32(ref)
    )(y)


@pytest.fixture(scope="module")
def devices_ok():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


class TestTimeShardedFir:
    def test_bit_identical_to_blockwise(self, devices_ok):
        """Sharded FIR == the same per-block conv run sequentially."""
        rng = np.random.default_rng(0)
        ch, n = 4, 1024
        L = 64
        h = rng.normal(size=L).astype(np.float32)
        x = (rng.normal(size=(ch, n)) + 1j * rng.normal(size=(ch, n))).astype(
            np.complex64
        )

        mesh = make_stream_mesh(8, ch=2)
        n_time = mesh.shape["time"]
        y_sharded = np.asarray(time_sharded_fir(h, jnp.asarray(x), mesh))

        # single-device reference: process the same time blocks sequentially
        f = FirFilter.create(h, batch_shape=(ch,), dtype=jnp.complex64)
        block = n // n_time
        parts = []
        for b in range(n_time):
            y, f = f.execute_block(x[:, b * block : (b + 1) * block])
            parts.append(np.asarray(y))
        y_seq = np.concatenate(parts, axis=-1)

        np.testing.assert_array_equal(y_sharded, y_seq)

    def test_mesh_shapes(self, devices_ok):
        mesh = make_stream_mesh(8, ch=2)
        assert mesh.shape["ch"] == 2 and mesh.shape["time"] == 4
        mesh = make_stream_mesh(8)
        assert mesh.shape["ch"] == 1 and mesh.shape["time"] == 8

    @pytest.mark.slow
    def test_with_history_seed(self, devices_ok):
        """Seeding stream-start history matches a warm filter."""
        rng = np.random.default_rng(1)
        h = rng.normal(size=16).astype(np.float32)
        ch, n = 2, 256
        hist = (rng.normal(size=(ch, 15)) + 1j * rng.normal(size=(ch, 15))).astype(
            np.complex64
        )
        x = (rng.normal(size=(ch, n)) + 1j * rng.normal(size=(ch, n))).astype(
            np.complex64
        )
        mesh = make_stream_mesh(8, ch=2)
        y_sharded = np.asarray(time_sharded_fir(h, jnp.asarray(x), mesh, history=jnp.asarray(hist)))

        f = FirFilter.create(h, batch_shape=(ch,), dtype=jnp.complex64)
        # warm the window with the history samples
        f = f.write(hist)
        n_time = mesh.shape["time"]
        block = n // n_time
        parts = []
        for b in range(n_time):
            y, f = f.execute_block(x[:, b * block : (b + 1) * block])
            parts.append(np.asarray(y))
        np.testing.assert_array_equal(y_sharded, np.concatenate(parts, axis=-1))


class TestRxChain:
    def test_chain_streaming_consistency(self):
        from yagi_tpu.chains import RxChain

        rng = np.random.default_rng(2)
        x = (rng.normal(size=2048) + 1j * rng.normal(size=2048)).astype(np.complex64)

        chain = RxChain.create()
        y_full, k_full, _ = chain.step(x)
        y_full = np.asarray(y_full)[: int(k_full)]

        chain2 = RxChain.create()
        parts = []
        for c in np.split(x, 4):
            y, k, chain2 = chain2.step(c)
            parts.append(np.asarray(y)[: int(k)])
        y_parts = np.concatenate(parts)
        assert len(y_full) == len(y_parts)
        np.testing.assert_allclose(y_full, y_parts, rtol=1e-4, atol=1e-5)

    def test_chain_jit(self):
        from yagi_tpu.chains import RxChain

        chain = RxChain.create()
        x = jnp.zeros(1024, dtype=jnp.complex64)
        step = jax.jit(lambda c, x: c.step(x))
        y, k, c2 = step(chain, x)
        assert y.shape[-1] == chain.resamp.out_capacity(1024)


class TestChannelRedistribution:
    """all_to_all channel↔time redistribution (SURVEY.md §7 phase 5)."""

    def test_channels_out_bit_identical(self, devices_ok):
        """Time-sharded in → channel-sharded out == single-device analyzer."""
        from jax.sharding import Mesh
        from yagi_tpu.multichannel import Firpfbch
        from yagi_tpu.parallel import sharded_channelize_to_channels

        rng = np.random.default_rng(3)
        M, n_dev = 16, 8
        chz = Firpfbch.create_kaiser(M, 4, 60.0)
        p = chz.p
        T = n_dev * 24
        x = (rng.normal(size=T * M) + 1j * rng.normal(size=T * M)).astype(
            np.complex64
        )
        mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("time",))
        y_sh = np.asarray(
            jax.jit(lambda v: sharded_channelize_to_channels(chz, v, mesh))(
                jnp.asarray(x)
            )
        )
        y_ref, _ = chz.analyzer_execute(jnp.asarray(x))
        y_ref = np.asarray(y_ref)
        assert y_sh.shape == y_ref.shape == (M, T)
        # bit-identical from step p (zero-state transient excluded, as in
        # sharded_channelize)
        np.testing.assert_array_equal(y_sh[:, p:], y_ref[:, p:])

    def test_fm_to_channels_no_seams(self, devices_ok):
        """Channel-sharded FM demod has NO internal block seams."""
        from jax.sharding import Mesh
        from yagi_tpu.multichannel import Firpfbch
        from yagi_tpu.parallel import sharded_channelize_fm_to_channels

        rng = np.random.default_rng(4)
        M, n_dev, kf = 16, 8, 0.1
        chz = Firpfbch.create_kaiser(M, 4, 60.0)
        p = chz.p
        T = n_dev * 24
        x = (rng.normal(size=T * M) + 1j * rng.normal(size=T * M)).astype(
            np.complex64
        )
        mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("time",))
        m_sh = np.asarray(
            jax.jit(
                lambda v: sharded_channelize_fm_to_channels(chz, kf, v, mesh)
            )(jnp.asarray(x))
        )
        y_ref, _ = chz.analyzer_execute(jnp.asarray(x))
        # single-device reference via the SAME elementwise device formula
        # as the sharded path — exact, not a host-f64 tolerance check
        m_ref = np.asarray(_device_fm(jnp.asarray(y_ref), kf))
        # emits all T-1 discriminator samples; steps ≥ p are transient-free
        assert m_sh.shape == (M, T - 1)
        np.testing.assert_array_equal(m_sh[:, p:], m_ref[:, p:])


class TestPipelinedStream:
    """Double-buffered streaming channelizer: the all_to_all for block t
    overlaps block t+1's analyzer compute (SCALING.md §4)."""

    def test_stream_bit_identical(self, devices_ok):
        """Pipelined B-block stream == single-device analyzer over the
        concatenated stream (zero-state transient excluded)."""
        from jax.sharding import Mesh
        from yagi_tpu.multichannel import Firpfbch
        from yagi_tpu.parallel import sharded_channelize_stream_to_channels

        rng = np.random.default_rng(11)
        M, n_dev, B = 16, 8, 5
        chz = Firpfbch.create_kaiser(M, 4, 60.0)
        p = chz.p
        T = n_dev * 24  # steps per block
        x = (rng.normal(size=(B, T * M)) + 1j * rng.normal(size=(B, T * M))
             ).astype(np.complex64)
        mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("time",))
        y_sh = np.asarray(
            jax.jit(
                lambda v: sharded_channelize_stream_to_channels(chz, v, mesh)
            )(jnp.asarray(x))
        )
        assert y_sh.shape == (B, M, T)
        y_ref, _ = chz.analyzer_execute(jnp.asarray(x.reshape(-1)))
        y_ref = np.asarray(y_ref).reshape(M, B, T).transpose(1, 0, 2)
        # block 0 steps ≥ p: exact; ALL later blocks exact from step 0 —
        # the streamed halo carries device n-1's tail across blocks
        np.testing.assert_array_equal(y_sh[0][:, p:], y_ref[0][:, p:])
        np.testing.assert_array_equal(y_sh[1:], y_ref[1:])

    def test_stream_fm_bit_identical(self, devices_ok):
        """Pipelined stream + per-channel FM demod: no seams anywhere."""
        from jax.sharding import Mesh
        from yagi_tpu.multichannel import Firpfbch
        from yagi_tpu.parallel import (
            sharded_channelize_stream_fm_to_channels,
        )

        rng = np.random.default_rng(12)
        M, n_dev, B, kf = 16, 8, 4, 0.1
        chz = Firpfbch.create_kaiser(M, 4, 60.0)
        p = chz.p
        T = n_dev * 24
        x = (rng.normal(size=(B, T * M)) + 1j * rng.normal(size=(B, T * M))
             ).astype(np.complex64)
        mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("time",))
        m_sh = np.asarray(
            jax.jit(
                lambda v: sharded_channelize_stream_fm_to_channels(
                    chz, kf, v, mesh
                )
            )(jnp.asarray(x))
        )
        assert m_sh.shape == (B, M, T)
        y_ref, _ = chz.analyzer_execute(jnp.asarray(x.reshape(-1)))
        y_ext = jnp.concatenate(
            [jnp.zeros((M, 1), jnp.complex64), jnp.asarray(y_ref)], axis=-1
        )
        m_ref = np.asarray(_device_fm(y_ext, kf))
        m_ref = m_ref.reshape(M, B, T).transpose(1, 0, 2)
        np.testing.assert_array_equal(m_sh[0][:, p + 1:], m_ref[0][:, p + 1:])
        np.testing.assert_array_equal(m_sh[1:], m_ref[1:])

    def test_pipeline_issue_order(self, devices_ok):
        """Structural overlap evidence on the traced program: inside the
        scanned pipeline body, the all_to_all's operand is the loop CARRY
        (previous block's analyzer output), never the current block's
        compute — so the collective and the analyzer have no data
        dependence and can execute concurrently."""
        from jax.sharding import Mesh
        from yagi_tpu.multichannel import Firpfbch
        from yagi_tpu.parallel import sharded_channelize_stream_to_channels

        M, n_dev, B = 16, 8, 3
        chz = Firpfbch.create_kaiser(M, 4, 60.0)
        T = n_dev * 24
        mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("time",))
        x = jnp.zeros((B, T * M), jnp.complex64)
        import re

        hlo = (
            jax.jit(lambda v: sharded_channelize_stream_to_channels(chz, v, mesh))
            .lower(x)
            .as_text()
        )
        # Inside the scanned pipeline (the while body region), the
        # all_to_all is the FIRST op and its operand is a BLOCK ARGUMENT
        # (%argN — the loop carry holding the previous block's analyzer
        # output). Nothing computed in the current iteration feeds it, so
        # the collective's start→done window is free to overlap the whole
        # analyzer compute of this iteration.
        m = re.search(r'%0 = "stablehlo\.all_to_all"\(%arg\d+\)', hlo)
        assert m, "while-body all_to_all must consume the loop carry"
        # and there is exactly one more all_to_all — the post-loop drain of
        # the final pending block
        assert hlo.count("stablehlo.all_to_all") == 2
