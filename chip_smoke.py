#!/usr/bin/env python
"""Smoke run of the five streaming receive chains on one GPU.

Drives BASELINE.json configs 0-4 through the library's own objects at the
widths ``bench.py`` uses, three blocks each with the state carried from
block to block, and checks every phase against plain references:

* configs 0, 1, 3 and 4: the XLA formulation on the GPU at full width
  (``RxChain``; ``Symsync(backend="xla")``; the joint ``QamRx`` scan; a
  direct frame-sum + cuFFT channelizer);
* every config: the same objects on ``jax.devices("cpu")`` with the XLA
  route, for a slice of 4 channels (catches TF32 and ordering differences).

For each check it prints the maximum absolute error and the maximum
relative error (max |got - ref| / max |ref|) beside their limits. The
feedback loops (configs 1 and 3) first compare each channel's emission
schedule: a channel whose schedule differs from the reference's (a float
ordering difference flipped a branch-index rounding) is counted as
diverged and leaves the value comparison; the phase fails above a stated
count. Wall time per block is printed for information only.

Usage::

    python chip_smoke.py              # the five configs on one GPU
    python chip_smoke.py --multi-gpu  # only the sharded channelizer, 4 GPUs

Exits non-zero, before printing any result, when JAX finds no GPU or any
phase fails. The last stdout line is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

BLOCKS = 3


def require_gpu(jax, count: int = 1):
    """Refuse to run unless JAX's devices are at least ``count`` GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPU(s); JAX found {devs}")
    return devs


def card_info() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


# ----------------------------------------------------------------- checks
def _errors(got, ref):
    got = np.asarray(got).astype(np.complex128)
    ref = np.asarray(ref).astype(np.complex128)
    if got.shape != ref.shape:
        raise AssertionError(f"shape {got.shape} != reference {ref.shape}")
    if got.size == 0:
        return 0.0, 0.0
    if not np.all(np.isfinite(got)):
        raise AssertionError("non-finite output")
    d = float(np.abs(got - ref).max())
    return d, d / max(float(np.abs(ref).max()), 1e-30)


def check(label, got, ref, atol, rtol):
    ea, er = _errors(got, ref)
    ok = ea <= atol and er <= rtol
    print(f"    {label}: max abs err {ea:.3e} (limit {atol:.1e}), "
          f"max rel err {er:.3e} (limit {rtol:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: error beyond its limit")


class Tracks:
    """Per-channel agreement of a feedback loop with its reference.

    Outputs are compared position by position from the stream start; a
    channel agrees up to its first position where the emission schedule
    (``sched``, one code per output) differs or a value is off by more
    than ``atol``. A float-order difference eventually flips a rounding
    (a branch index, a hard decision) and the two loops then follow
    different, equally valid trajectories; a wrong formulation diverges at
    once. The check fails when the median channel agrees for fewer than
    ``min_run`` outputs."""

    def __init__(self, label, channels, atol, min_run):
        self.label, self.atol, self.min_run = label, atol, min_run
        self.run = np.zeros(channels, np.int64)
        self.live = np.ones(channels, bool)
        self.total = 0
        self.err = 0.0

    def update(self, got_sched, ref_sched, got, ref):
        c = self.run.shape[0]
        gs = np.asarray(got_sched).reshape(c, -1)
        rs = np.asarray(ref_sched).reshape(c, -1)
        got = np.asarray(got).reshape(c, -1)
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"{self.label}: non-finite output")
        d = np.abs(got.astype(np.complex128) - np.asarray(ref).reshape(c, -1))
        bad = (gs != rs) | (d > self.atol)
        n = bad.shape[1]
        first = np.where(bad.any(axis=1), bad.argmax(axis=1), n)
        for ch in np.flatnonzero(self.live):
            self.err = max(self.err, float(d[ch, :first[ch]].max(initial=0.0)))
        self.run += np.where(self.live, first, 0)
        self.live &= first == n
        self.total += n

    def report(self):
        med = float(np.median(self.run))
        ok = med >= self.min_run
        print(f"    {self.label}: outputs agree from the start for a median "
              f"{med:.0f} of {self.total} per channel (limit >= "
              f"{self.min_run}; min {self.run.min()}, "
              f"{int(self.live.sum())}/{self.run.shape[0]} channels never "
              f"diverge), max abs err before divergence {self.err:.3e} "
              f"(limit {self.atol:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{self.label}: diverges too early")


def quality(label, got_db, ref_db, floor_db, slack_db=1.0, higher=True):
    """Median of a per-channel quality figure (dB) for the route under
    test against its reference: within ``slack_db``, and past ``floor_db``
    (above it when ``higher``, else below)."""
    g, r = float(np.median(got_db)), float(np.median(ref_db))
    sign = 1.0 if higher else -1.0
    ok = sign * (g - r) >= -slack_db and sign * (g - floor_db) >= 0
    print(f"    {label}: median {g:.2f} dB vs reference {r:.2f} dB (within "
          f"{slack_db} dB, {'above' if higher else 'below'} {floor_db} dB) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: quality off")


def _run_blocks(jax, step, state, xs):
    """Run ``step(state, x)`` over the blocks; returns (outs, state, times)."""
    outs, times = [], []
    for x in xs:
        t0 = time.perf_counter()
        out = step(state, x)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
        state = out[-1]
        outs.append(jax.tree_util.tree_map(np.asarray, out[:-1]))
    return outs, state, times


def _times(label, times):
    rest = ", ".join(f"{t * 1e3:.3f}" for t in times[1:])
    print(f"    {label} wall time per block: first {times[0]:.3f} s "
          f"(compile included), then {rest} ms")


# ---------------------------------------------------------------- signals
def _rrc(t, beta):
    """Root-raised-cosine pulse at ``t`` symbol periods (analytic form)."""
    import jax.numpy as jnp

    t = jnp.where(jnp.abs(t) < 1e-4, 1e-4, t)
    t = jnp.where(jnp.abs(jnp.abs(t) - 1 / (4 * beta)) < 1e-4, t + 2e-4, t)
    num = (jnp.sin(jnp.pi * t * (1 - beta))
           + 4 * beta * t * jnp.cos(jnp.pi * t * (1 + beta)))
    return num / (jnp.pi * t * (1 - (4 * beta * t) ** 2))


def linear_signal(jax, rng, table, channels, n, sps, beta=0.3, snr_db=30.0):
    """Pulse-shaped symbols from ``table`` at ``sps`` samples per symbol,
    with a random timing offset and carrier phase per channel, plus noise.
    Returns complex64 numpy [channels, n]."""
    import jax.numpy as jnp

    n_sym = int(n / sps) + 20
    a = jnp.asarray(np.asarray(table)[
        rng.integers(0, len(table), (channels, n_sym))].astype(np.complex64))
    tau = jnp.asarray(rng.uniform(0, 1, (channels, 1)).astype(np.float32))
    phase = jnp.asarray(rng.uniform(-0.3, 0.3, (channels, 1)).astype(np.float32))
    noise = (rng.standard_normal((channels, n))
             + 1j * rng.standard_normal((channels, n))).astype(np.complex64)

    @jax.jit
    def synth(a, tau, phase, noise):
        u = jnp.arange(n, dtype=jnp.float32)[None, :] / sps - tau + 8.0
        k0 = jnp.floor(u).astype(jnp.int32)
        x = jnp.zeros((channels, n), jnp.complex64)
        for o in range(-8, 9):
            k = jnp.clip(k0 + o, 0, n_sym - 1)
            x = x + jnp.take_along_axis(a, k, axis=1) * _rrc(u - (k0 + o), beta)
        x = x * jnp.exp(1j * phase)
        sig = jnp.sqrt(jnp.mean(jnp.abs(x) ** 2))
        return x + noise * (sig * 10 ** (-snr_db / 20) / jnp.sqrt(2.0))

    return np.asarray(synth(a, tau, phase, jnp.asarray(noise)))


def fm_stereo_signal(rng, channels, n, kf=0.5):
    """FM-modulated stereo multiplex (L+R, 19 kHz pilot, L-R on 38 kHz)
    per channel at fs = 200 kHz; complex64 numpy [channels, n]."""
    t = np.arange(n)[None, :] / 200e3
    fl = rng.uniform(300, 3000, (channels, 1))
    fr = rng.uniform(300, 3000, (channels, 1))
    left = np.sin(2 * np.pi * fl * t)
    right = np.sin(2 * np.pi * fr * t)
    mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19e3 * t)
           + 0.45 * (left - right) * np.sin(2 * np.pi * 38e3 * t))
    phase = 2 * np.pi * kf * np.cumsum(mpx, axis=1)
    return np.exp(1j * phase).astype(np.complex64)


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ----------------------------------------------------------------- phases
def phase_chain(jax, jnp, cpu, rng, C=16, T=1 << 17):
    """config[0]: FIR → 2× resampler → NCO mix, C=16, block 131,072."""
    from yagi_tpu.chains import FusedRxChain, RxChain

    xs = [_cplx(rng, (C, T)) for _ in range(BLOCKS)]
    chain = FusedRxChain.create(batch_shape=(C,))
    route = "triton kernel" if chain.uses_kernel(T) else "xla"
    print(f"config[0] FusedRxChain C={C} block={T}: route {route}")
    step = jax.jit(lambda c, x: c.step(x))
    outs, _, times = _run_blocks(jax, step, chain, xs)
    _times(route, times)
    refs, _, rtimes = _run_blocks(jax, step, RxChain.create(batch_shape=(C,)),
                                  xs)
    _times("RxChain (xla)", rtimes)
    for b, ((y, k), (r, kr)) in enumerate(zip(outs, refs)):
        assert int(k) == int(kr) == 2 * T
        # f32 sums of the 77 combined taps in another order than the XLA
        # banded matmul; magnitudes ~1-10
        check(f"block {b} vs RxChain (GPU, {C} ch)", y, r[:, :int(kr)],
              5e-5, 1e-5)
    with jax.default_device(cpu):
        cpu_outs, _, _ = _run_blocks(
            jax, step, FusedRxChain.create(batch_shape=(4,), backend="xla"),
            [x[:4] for x in xs])
    for b, ((y, _), (r, _)) in enumerate(zip(outs, cpu_outs)):
        check(f"block {b} vs CPU (4 ch)", y[:4], r, 5e-5, 1e-5)


def phase_symsync(jax, jnp, cpu, rng, C=1024, T=4096):
    """config[1]: farrow MsResamp → Symsync.execute_slots(n_valid), C=1024."""
    from yagi_tpu.design import FirFilterShape
    from yagi_tpu.filter import MsResamp, Symsync
    from yagi_tpu.kernels import use_kernel
    from yagi_tpu.kernels.symscan import supported

    sps = 2.0663
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4)))
    x_all = linear_signal(jax, rng, qpsk, C, BLOCKS * T, sps)
    xs = [x_all[:, b * T:(b + 1) * T] for b in range(BLOCKS)]

    def make(c):
        ms = MsResamp.create(2.0 / sps, batch_shape=(c,),
                             arbitrary_interp="farrow")
        ss = Symsync.create_rnyquist(FirFilterShape.RRCOS, 2, 7, 0.3,
                                     batch_shape=(c,)).set_lf_bw(0.02)
        return ms, ss

    def stepper(backend):
        def step(st, x):
            ms, ss = st
            y, cnt, ms = ms.execute_block(x)
            ys, vs, ss = ss.execute_slots(y, n_valid=cnt, backend=backend)
            return ys, vs, (ms, ss)
        return jax.jit(step)

    ms, ss = make(C)
    route = ("triton kernel" if use_kernel("auto", supported((C,), ss.mf.shape[1]))
             else "xla")
    print(f"config[1] MsResamp(farrow) -> Symsync C={C} block={T}: "
          f"route {route}")
    outs, _, times = _run_blocks(jax, stepper("auto"), (ms, ss), xs)
    _times(route, times)
    refs, _, rtimes = _run_blocks(jax, stepper("xla"), make(C), xs)
    _times("Symsync (xla)", rtimes)
    with jax.default_device(cpu):
        cpu_outs, _, _ = _run_blocks(jax, stepper("xla"), make(4),
                                     [x[:4] for x in xs])
    # feedback loop: float-order differences ride the loop state forward
    # (a wrong formulation diverges within the first emissions)
    min_run = T // 8
    gpu_t = Tracks("vs Symsync xla (GPU)", C, 1e-3, min_run)
    cpu_t = Tracks("vs CPU (4 ch)", 4, 1e-3, min_run)
    for b in range(BLOCKS):
        (y, v), (yr, vr), (yc, vc) = outs[b], refs[b], cpu_outs[b]
        gpu_t.update(v, vr, y, yr)
        cpu_t.update(v[:4], vc, y[:4], yc)
    gpu_t.report()
    cpu_t.report()
    quality("QPSK amplitude MER of the last block", _mer_db(*outs[-1]),
            _mer_db(*refs[-1]), 15.0)


def _mer_db(y, v):
    """Per-channel amplitude MER (dB) of QPSK symbol estimates: the mean
    |y|² over the variance of |y| (constant-envelope symbols, so timing
    error and ISI show up as amplitude spread)."""
    a = np.where(v, np.abs(y), np.nan).reshape(y.shape[0], -1)
    return 10 * np.log10(np.nanmean(a, 1) ** 2 / np.nanvar(a, 1))


def phase_fm(jax, jnp, cpu, rng, C=512, T=1 << 14):
    """config[2]: FmStereoRx, C=512, block 16,384."""
    from yagi_tpu.chains import FmStereoRx

    x_all = fm_stereo_signal(rng, C, BLOCKS * T)
    xs = [x_all[:, b * T:(b + 1) * T] for b in range(BLOCKS)]
    print(f"config[2] FmStereoRx C={C} block={T}: route xla")
    step = jax.jit(lambda s, x: s.step(x))
    outs, _, times = _run_blocks(jax, step, FmStereoRx.create(batch_shape=(C,)),
                                 xs)
    _times("xla", times)
    with jax.default_device(cpu):
        cpu_outs, _, _ = _run_blocks(
            jax, step, FmStereoRx.create(batch_shape=(4,)), [x[:4] for x in xs])
    for b, (o, r) in enumerate(zip(outs, cpu_outs)):
        for name, got, ref in zip(("left", "right", "pilot"), o, r):
            check(f"block {b} {name} vs CPU (4 ch)", got[:4], ref, 1e-4, 1e-4)


def phase_qam(jax, jnp, cpu, rng, C=2048, T=4096):
    """config[3]: QamRx.step_masked, C=2048, block 4,096."""
    from yagi_tpu.chains import QamRx
    from yagi_tpu.kernels import use_kernel
    from yagi_tpu.kernels.symscan import supported
    from yagi_tpu.modem import Modem

    table = np.asarray(Modem.create("qam16").table)
    x_all = linear_signal(jax, rng, table, C, BLOCKS * T, 2.0)
    xs = [x_all[:, b * T:(b + 1) * T] for b in range(BLOCKS)]
    rx = QamRx.create(batch_shape=(C,))
    route = ("triton kernel + eq scan"
             if use_kernel("auto", supported((C,), rx.symsync.mf.shape[1]))
             else "xla joint scan")
    print(f"config[3] QamRx.step_masked C={C} block={T}: route {route}")

    def stepper(backend):
        return jax.jit(lambda s, x: s.step_masked(x, backend=backend))

    outs, state, times = _run_blocks(jax, stepper("auto"), rx, xs)
    _times(route, times)
    refs, ref_state, rtimes = _run_blocks(jax, stepper("xla"),
                                          QamRx.create(batch_shape=(C,)), xs)
    _times("joint scan (xla)", rtimes)
    with jax.default_device(cpu):
        cpu_outs, _, _ = _run_blocks(jax, stepper("xla"),
                                     QamRx.create(batch_shape=(4,)),
                                     [x[:4] for x in xs])
    # a channel's schedule is its mask and hard decisions (the decision-
    # directed eq and carrier loops take another update after a flip)
    min_run = T // 8
    gpu_t = Tracks("vs joint scan (GPU)", C, 1e-3, min_run)
    cpu_t = Tracks("vs CPU (4 ch)", 4, 1e-3, min_run)

    def code(s, m):  # 0 = no symbol, 1 + decision otherwise
        return np.where(m, np.asarray(s, np.int64) + 1, 0)

    for b in range(BLOCKS):
        (s, soft, m), (sr, softr, mr), (sc, softc, mc) = (
            outs[b], refs[b], cpu_outs[b])
        gpu_t.update(code(s, m), code(sr, mr), np.where(m, soft, 0),
                     np.where(mr, softr, 0))
        cpu_t.update(code(s, m)[:4], code(sc, mc), np.where(m, soft, 0)[:4],
                     np.where(mc, softc, 0))
    gpu_t.report()
    cpu_t.report()
    quality("EVM after 3 blocks", np.asarray(state.get_evm()),
            np.asarray(ref_state.get_evm()), -15.0, higher=False)


def channelizer_reference(jnp, h, M, hist, x):
    """Direct analysis bank: y_k[n] = Σ_j h[j]·x[nM - j]·e^{+j2πkj/M},
    as frame sums + cuFFT. ``hist``: the previous L-1 input samples."""
    L = h.shape[0]
    xa = jnp.concatenate([hist, x])
    n = x.shape[0] // M
    idx = (L - 1) + jnp.arange(n)[:, None] * M - jnp.arange(L)[None, :]
    v = (xa[idx] * h[None, :]).reshape(n, L // M, M).sum(axis=1)
    return (jnp.fft.ifft(v, axis=-1) * M).T, xa[xa.shape[0] - (L - 1):]


def phase_channelizer(jax, jnp, cpu, rng, M=64, T=1 << 15):
    """config[4]: 64-channel Firpfbch + FM discriminator, T=32,768 steps."""
    from bench import fm_discriminator
    from yagi_tpu.multichannel import Firpfbch
    from yagi_tpu.multichannel.firpfbch import _design_prototype

    xs = [_cplx(rng, T * M) for _ in range(BLOCKS)]
    print(f"config[4] Firpfbch + FM discriminator M={M} T={T}: route xla")

    def step_y(chz, x):
        y, new = chz.analyzer_execute(x)
        return y, fm_discriminator(y), new

    run = jax.jit(step_y)
    outs, _, times = _run_blocks(jax, run, Firpfbch.create_kaiser(M, 4, 60.0),
                                 xs)
    _times("xla", times)
    h = jnp.asarray(_design_prototype(M, 4, 60.0).astype(np.float32))
    ref = jax.jit(lambda hist, x: channelizer_reference(jnp, h, M, hist, x))
    hist = jnp.zeros(h.shape[0] - 1, jnp.complex64)
    with jax.default_device(cpu):
        cpu_outs, _, _ = _run_blocks(jax, jax.jit(step_y),
                                     Firpfbch.create_kaiser(M, 4, 60.0), xs)
    for b in range(BLOCKS):
        y, fm = outs[b]
        yr, hist = ref(hist, jnp.asarray(xs[b]))
        yr = np.asarray(yr)
        check(f"block {b} channels vs frame-sum + FFT (GPU)", y, yr,
              1e-4, 1e-5)
        yc, fmc = cpu_outs[b]
        check(f"block {b} channels vs CPU (4 ch)", y[:4], yc[:4], 1e-4, 1e-5)
        # the discriminator's angle is ill-conditioned where a channel
        # sample is near zero: compare where both samples are ≥ 1% of rms
        rms = np.sqrt(np.mean(np.abs(yr) ** 2))
        good = np.minimum(np.abs(yr[:, :-1]), np.abs(yr[:, 1:])) > 0.01 * rms
        fm_ref = np.angle(np.conj(yr[:, :-1]) * yr[:, 1:]) / (2 * np.pi * 0.1)
        check(f"block {b} FM vs frame-sum reference ({good.mean():.4f} of "
              f"samples)", fm[good], fm_ref[good], 1e-2, 1e-3)
        g4 = good[:4]
        check(f"block {b} FM vs CPU (4 ch)", fm[:4][g4], fmc[:4][g4],
              1e-2, 1e-3)


def phase_multi_gpu(jax):
    """Sharded channelizer paths on a 4-GPU mesh vs one GPU."""
    import __graft_entry__ as entry

    print("multi-gpu: dryrun_multichip(4), M=64, 32768 steps per card, "
          f"{BLOCKS} blocks")
    errs = entry.dryrun_multichip(4, t_per_device=1 << 15, blocks=BLOCKS,
                                  atol=1e-3, fm_atol=5e-2)
    for name, e in errs.items():
        print(f"    {name}: {'bit-identical' if e == 0 else f'max abs err {e:.3e}'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the sharded channelizer phase on 4 GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    devs = require_gpu(jax, 4 if args.multi_gpu else 1)
    from yagi_tpu.utils.compile_cache import enable_compile_cache

    print(f"jax {jax.__version__}")
    print(f"devices {devs}")
    print(f"nvidia-smi: {card_info()}")
    print(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.multi_gpu:
        phase_multi_gpu(jax)
    else:
        cpu = jax.devices("cpu")[0]
        rng = np.random.default_rng(args.seed)
        for phase in (phase_chain, phase_symsync, phase_fm, phase_qam,
                      phase_channelizer):
            t1 = time.perf_counter()
            phase(jax, jnp, cpu, rng)
            print(f"    phase time {time.perf_counter() - t1:.1f} s")
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
