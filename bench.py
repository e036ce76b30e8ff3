#!/usr/bin/env python
"""Benchmark: complex Msamples/s per card through the five receive chains.

Headline: BASELINE.json config[0] — 64-tap kaiser lowpass → 2x polyphase
resampler → NCO mix-down, 16 channels, streaming blocks with full state
carry, through :class:`FusedRxChain` (one Triton kernel on the GPU,
kernels/chain.py). Configs 1-4 are reported on stderr.

Each timing runs a chain of ``n_steps`` blocks with the state threaded
through and ends in ``block_until_ready``; the first call of every shape
compiles outside the timed window. Needs a GPU: with none, it exits
non-zero before measuring. Exits non-zero if any config fails.

Usage: ``python bench.py``. Prints ONE JSON line on stdout:
``{"metric", "value", "unit", "device", "configs"}``.
"""

import json
import sys
import time

import numpy as np

from chip_smoke import card_info, require_gpu


def _timed_chain(jax, step, state, args, samples_per_step, n_steps, reps):
    """Median Msps of ``n_steps`` chained ``step(state, *args)`` calls.

    ``step`` returns ``(outputs..., new_state)``; every output of the last
    call is checked finite."""
    out = step(state, *args)  # compile
    jax.block_until_ready(out)
    rates = []
    for _ in range(reps):
        c = state
        t0 = time.perf_counter()
        for _ in range(n_steps):
            out = step(c, *args)
            c = out[-1]
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        rates.append(samples_per_step * n_steps / dt / 1e6)
    for leaf in jax.tree_util.tree_leaves(out[:-1]):
        v = np.asarray(leaf)
        if np.issubdtype(v.dtype, np.inexact):
            assert np.isfinite(v).all(), "non-finite bench output"
    return float(np.median(rates)), rates


def _planar(jnp, x):
    from yagi_tpu.utils.planar import Planar

    return Planar(jnp.asarray(np.ascontiguousarray(x.real)),
                  jnp.asarray(np.ascontiguousarray(x.imag)))


def _cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def bench_fused_chain(jax, jnp, channels=16, block=1 << 17, n_steps=512,
                      reps=5, backend="auto"):
    """Config[0] through :class:`FusedRxChain`. Returns (median_msps, rates)."""
    from yagi_tpu.chains import FusedRxChain

    rng = np.random.default_rng(0)
    xr = jnp.asarray(rng.standard_normal((channels, block)).astype(np.float32))
    xi = jnp.asarray(rng.standard_normal((channels, block)).astype(np.float32))
    chain = jax.jit(lambda: FusedRxChain.create(
        n_taps=64, fc=0.2, as_=60.0, rate=2.0, mix_freq=0.35,
        batch_shape=(channels,), backend=backend,
    ))()
    step = jax.jit(lambda c, a, b: c.step_planar(a, b))
    return _timed_chain(jax, step, chain, (xr, xi), channels * block,
                        n_steps, reps)


def fm_discriminator(y, kf=0.1):
    """Per-channel FM discriminator over channel-major [M, T] samples:
    arg(conj(y[n-1])·y[n]) / (2π·kf) → [M, T-1]."""
    import jax.numpy as jnp

    ref = 1.0 / (2.0 * np.pi * kf)
    return jnp.angle(jnp.conj(y[:, :-1]) * y[:, 1:]) * jnp.float32(ref)


def channelizer_fm_step(chz, x):
    """Config[4] step: M-channel analysis → FM discriminator per channel."""
    y, chz = chz.analyzer_execute(x)
    return fm_discriminator(y), chz


def bench_channelizer_fm(jax, jnp, M=64, T=1 << 15, n_steps=192, reps=3):
    """Config[4]: M-channel polyphase channelizer (:class:`Firpfbch`, XLA
    polyphase FIR + matmul IDFT) + FM discriminator per channel."""
    from yagi_tpu.multichannel import Firpfbch

    rng = np.random.default_rng(1)
    x = jnp.asarray(_cplx(rng, T * M))
    chz = Firpfbch.create_kaiser(M, 4, 60.0)
    return _timed_chain(jax, jax.jit(channelizer_fm_step), chz, (x,),
                        T * M, n_steps, reps)


def _planar_chain(jax, jnp, make_state, step_fn, x, samples_per_step,
                  n_steps, reps):
    from yagi_tpu.utils.planar import planar_jit

    state = planar_jit(make_state)()
    return _timed_chain(jax, planar_jit(step_fn), state, (_planar(jnp, x),),
                        samples_per_step, n_steps, reps)


def bench_symsync(jax, jnp, channels=1024, block=4096, n_steps=8, reps=3,
                  backend="auto"):
    """Config[1] as BASELINE states: ARBITRARY-rate msresamp + QPSK
    symbol-timing recovery. Input at 2.0663 samples/symbol; the msresamp
    (rate 2/2.0663 ≈ 0.96796 — truly arbitrary, farrow production mode,
    filter/_farrow_resamp.py) brings it to exactly 2, and the symsync
    (per-sample feedback loop, symsync.rs:230-266) consumes the
    variable-count resampler output through the valid-prefix streaming API
    (execute_slots(n_valid=...)). Channel-parallel across C streams."""
    from yagi_tpu.design import FirFilterShape
    from yagi_tpu.filter import MsResamp, Symsync

    rng = np.random.default_rng(2)
    x = _cplx(rng, (channels, block))

    def mk():
        ms = MsResamp.create(
            2.0 / 2.0663, batch_shape=(channels,), arbitrary_interp="farrow"
        )
        ss = Symsync.create_rnyquist(
            FirFilterShape.RRCOS, 2, 7, 0.3, batch_shape=(channels,)
        ).set_lf_bw(0.02)
        return (ms, ss)

    def step(st, v):
        ms, ss = st
        y, cnt, ms = ms.execute_block(v)
        slots, vmask, ss = ss.execute_slots(y, n_valid=cnt, backend=backend)
        return slots, vmask, (ms, ss)

    return _planar_chain(jax, jnp, mk, step, x, channels * block, n_steps,
                         reps)


def bench_fm_stereo(jax, jnp, channels=512, block=1 << 14, n_steps=8, reps=3):
    """Config[2]: FM stereo receive chain (chains/fm.py), C=512 channels."""
    from yagi_tpu.chains import FmStereoRx

    rng = np.random.default_rng(3)
    x = _cplx(rng, (channels, block), 0.1)
    return _planar_chain(
        jax, jnp, lambda: FmStereoRx.create(batch_shape=(channels,)),
        lambda s, v: s.step(v), x, channels * block, n_steps, reps,
    )


def bench_qamrx(jax, jnp, channels=2048, block=4096, n_steps=4, reps=3,
                backend="auto"):
    """Config[3]: 16-QAM receiver with EVM tracking (chains/qam.py),
    C=2048 channels, through ``step_masked`` (masked outputs; ``step``
    adds one compaction pass)."""
    from yagi_tpu.chains import QamRx

    rng = np.random.default_rng(4)
    x = _cplx(rng, (channels, block))
    return _planar_chain(
        jax, jnp, lambda: QamRx.create(batch_shape=(channels,)),
        lambda s, v: s.step_masked(v, backend=backend), x,
        channels * block, n_steps, reps,
    )


def main() -> int:
    import jax
    import jax.numpy as jnp

    from yagi_tpu.utils.compile_cache import enable_compile_cache

    require_gpu(jax)
    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"[device] {device} | {card_info()}", file=sys.stderr)

    configs = [
        ("config[0] fir64+resamp2x+ncomix chain", bench_fused_chain),
        ("config[4] 64-ch channelizer+FM", bench_channelizer_fm),
        ("config[1] arb-rate msresamp+symsync", bench_symsync),
        ("config[2] FM stereo chain", bench_fm_stereo),
        ("config[3] 16-QAM EVM receiver", bench_qamrx),
    ]
    results, failed = {}, []
    for name, fn in configs:
        try:
            msps, rates = fn(jax, jnp)
        except Exception as e:  # reported, and the run exits non-zero
            failed.append(name)
            print(f"[config] {name} FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr)
            continue
        results[name] = msps
        print(f"[config] {name}: {msps:.1f} Msps/card "
              f"(min/max {min(rates):.1f}/{max(rates):.1f})", file=sys.stderr)
    if failed:
        print(f"[bench] {len(failed)} config(s) failed: {failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "complex Msamples/s/card, firfilt64+resamp2x+ncomix chain",
        "value": round(results[configs[0][0]], 2),
        "unit": "Msamples/s",
        "device": device,
        "configs": {k: round(v, 2) for k, v in results.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
