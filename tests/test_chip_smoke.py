"""chip_smoke.py, bench.py and the compile-cache helper, on the CPU.

The smoke's phases run here at tiny widths on the XLA route (the GPU run is
the same code at the bench widths); its device guard must refuse a run
without a GPU, and so must the script in a directory that holds nothing
else of the repository.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu"}


class TestDeviceGuard:
    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(SystemExit) as e:
            chip_smoke.require_gpu(jax)
        assert "needs 1 GPU" in str(e.value)

    def test_require_gpu_counts_cards(self, monkeypatch):
        class Dev:
            platform = "gpu"

        monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
        assert len(chip_smoke.require_gpu(jax, 1)) == 1
        with pytest.raises(SystemExit):
            chip_smoke.require_gpu(jax, 4)

    @pytest.mark.parametrize("argv", [[], ["--multi-gpu"]])
    def test_script_fails_without_gpu(self, argv):
        r = subprocess.run([sys.executable, "chip_smoke.py", *argv], cwd=_REPO,
                           env=_env(), capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "needs" in r.stderr

    def test_script_fails_alone(self, tmp_path):
        shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
        env = {k: v for k, v in _env().items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_bench_fails_without_gpu(self):
        r = subprocess.run([sys.executable, "bench.py"], cwd=_REPO,
                           env=_env(), capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert r.stdout.strip() == ""


class TestSmokePhasesSmall:
    """Each phase end to end at a tiny width on the CPU (XLA route)."""

    @pytest.fixture
    def ctx(self):
        return jax, jnp, jax.devices("cpu")[0], np.random.default_rng(0)

    def test_chain(self, ctx, capsys):
        chip_smoke.phase_chain(*ctx, C=4, T=1024)
        out = capsys.readouterr().out
        assert "route xla" in out and "FAIL" not in out

    def test_symsync(self, ctx, capsys):
        chip_smoke.phase_symsync(*ctx, C=8, T=256)
        out = capsys.readouterr().out
        assert "8/8 channels never diverge" in out

    def test_fm(self, ctx, capsys):
        chip_smoke.phase_fm(*ctx, C=4, T=1024)
        assert "FAIL" not in capsys.readouterr().out

    def test_qam(self, ctx, capsys):
        chip_smoke.phase_qam(*ctx, C=8, T=512)
        out = capsys.readouterr().out
        assert "8/8 channels never diverge" in out and "EVM" in out

    def test_channelizer(self, ctx, capsys):
        chip_smoke.phase_channelizer(*ctx, M=64, T=128)
        assert "FAIL" not in capsys.readouterr().out


class TestSmokeChecks:
    def test_check_passes_and_fails(self, capsys):
        a = np.ones(8, np.complex64)
        chip_smoke.check("same", a, a, 0.0, 0.0)
        with pytest.raises(AssertionError):
            chip_smoke.check("off", a + 1e-3, a, 1e-4, 1.0)
        with pytest.raises(AssertionError):
            chip_smoke.check("shape", a[:4], a, 1.0, 1.0)
        with pytest.raises(AssertionError):
            chip_smoke.check("nan", a * np.nan, a, 1.0, 1.0)
        assert "limit" in capsys.readouterr().out

    def test_tracks_measure_agreement_from_the_start(self):
        t = chip_smoke.Tracks("x", 4, 1e-3, 5)
        ref = np.zeros((4, 6), bool)
        vals = np.zeros((4, 6))
        got = ref.copy()
        got[2, 3] = True  # schedule flip at 3
        gv = vals.copy()
        gv[1, 5] = 1.0  # value off at 5
        t.update(got, ref, gv, vals)
        assert t.run.tolist() == [6, 5, 3, 6]
        assert t.live.tolist() == [True, False, False, True]
        t.update(ref, ref, vals, vals)  # diverged channels stay diverged
        assert t.run.tolist() == [12, 5, 3, 12] and t.total == 12
        t.report()  # median 8.5 >= 5
        t.min_run = 10
        with pytest.raises(AssertionError):
            t.report()

    def test_channelizer_reference_matches_firpfbch(self):
        from yagi_tpu.multichannel import Firpfbch
        from yagi_tpu.multichannel.firpfbch import _design_prototype

        M, T = 8, 64
        h = jnp.asarray(_design_prototype(M, 4, 60.0).astype(np.float32))
        rng = np.random.default_rng(1)
        chz = Firpfbch.create_kaiser(M, 4, 60.0)
        hist = jnp.zeros(h.shape[0] - 1, jnp.complex64)
        for _ in range(2):
            x = jnp.asarray(chip_smoke._cplx(rng, T * M))
            y, chz = chz.analyzer_execute(x)
            yr, hist = chip_smoke.channelizer_reference(jnp, h, M, hist, x)
            np.testing.assert_allclose(np.asarray(y), np.asarray(yr),
                                       atol=1e-5)

    def test_linear_signal_shape_and_power(self):
        qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4)))
        x = chip_smoke.linear_signal(jax, np.random.default_rng(2), qpsk, 3,
                                     500, 2.0663)
        assert x.shape == (3, 500) and x.dtype == np.complex64
        p = np.mean(np.abs(x[:, 50:]) ** 2)
        assert 0.2 < p < 5.0

    def test_fm_stereo_signal_is_constant_envelope(self):
        x = chip_smoke.fm_stereo_signal(np.random.default_rng(3), 2, 1000)
        np.testing.assert_allclose(np.abs(x), 1.0, rtol=1e-5)


class TestCompileCache:
    def test_env_unset_uses_checkout(self, monkeypatch):
        from yagi_tpu.utils import compile_cache as cc

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cc.compile_cache_dir() == os.path.join(_REPO, ".jax_cache")
        before = jax.config.jax_compilation_cache_dir
        try:
            assert cc.enable_compile_cache() == os.path.join(_REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == cc.compile_cache_dir()
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_env_set_is_used_and_nothing_set(self, monkeypatch, tmp_path):
        from yagi_tpu.utils import compile_cache as cc

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert cc.compile_cache_dir() == str(tmp_path)
        assert cc.enable_compile_cache() == str(tmp_path)
        assert calls == []

    def test_checkout_cache_is_ignored_by_git(self):
        with open(os.path.join(_REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestKernelRouting:
    @pytest.mark.parametrize("backend,supported,expect", [
        ("xla", True, False), ("triton", True, True), ("triton", False, False),
        ("auto", True, False), ("auto", False, False),
    ])
    def test_use_kernel_on_cpu(self, backend, supported, expect):
        from yagi_tpu.kernels import use_kernel

        assert use_kernel(backend, supported) is expect

    def test_auto_takes_kernel_on_gpu(self, monkeypatch):
        from yagi_tpu.kernels import use_kernel

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert use_kernel("auto", True) is True
        assert use_kernel("auto", False) is False

    def test_unknown_backend(self):
        from yagi_tpu.errors import ConfigError
        from yagi_tpu.kernels import use_kernel

        with pytest.raises(ConfigError):
            use_kernel("mosaic", True)


class TestEntryPoints:
    def test_entry_runs_xla_route_on_cpu(self):
        import __graft_entry__ as g

        fn, args = g.entry()
        assert not args[0].interpret
        yr, yi, k, _ = jax.jit(fn)(*args)
        assert yr.shape == (4, 32768) and int(k) == 32768

    def test_fm_discriminator(self):
        import bench

        ph = np.cumsum(np.full((2, 50), 0.3))
        y = jnp.asarray(np.exp(1j * ph).reshape(2, 50).astype(np.complex64))
        fm = np.asarray(bench.fm_discriminator(y, kf=0.1))
        assert fm.shape == (2, 49)
        np.testing.assert_allclose(fm, 0.3 / (2 * np.pi * 0.1), rtol=1e-4)

    def test_route_ab_tool_imports(self):
        sys.path.insert(0, os.path.join(_REPO, "tools"))
        try:
            import route_ab
        finally:
            sys.path.pop(0)
        assert callable(route_ab.main)

    def test_last_line_contract(self, monkeypatch, capsys):
        """With a GPU present the last stdout line is the contract object."""

        class Dev:
            platform = "gpu"
            device_kind = "NVIDIA H100 80GB HBM3"

        monkeypatch.setattr(chip_smoke, "require_gpu", lambda jax, n=1: [Dev()])
        monkeypatch.setattr(chip_smoke, "card_info", lambda: "card, 700 W")
        monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
        for name in ("phase_chain", "phase_symsync", "phase_fm", "phase_qam",
                     "phase_channelizer"):
            monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
        assert chip_smoke.main([]) == 0
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(last) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
