#!/usr/bin/env python
"""A/B of each kernel against its plain XLA route, end to end per config.

For configs 0, 1 and 3 it times the ``bench.py`` step with the kernel
route (``backend="auto"`` on the GPU) and with ``backend="xla"``, in turns
(kernel, xla, xla, kernel), at the bench widths; config[0] also times the
three-stage XLA ``RxChain``. ``--sweep`` times the symsync kernel alone over
its channels-per-program choice; ``--trace DIR`` writes a profiler trace of
config[4]'s channelizer step and prints the device time per kernel.

Usage: ``python tools/route_ab.py [--sweep] [--trace DIR] [--skip-ab]``
(needs a GPU).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from chip_smoke import card_info, require_gpu  # noqa: E402


def bench_rx_chain(jax, jnp, channels=16, block=1 << 17, n_steps=512, reps=5):
    """Config[0] through the three-stage XLA :class:`RxChain`."""
    from yagi_tpu.chains import RxChain

    rng = np.random.default_rng(0)
    x = jnp.asarray(bench._cplx(rng, (channels, block)))
    chain = RxChain.create(batch_shape=(channels,))
    return bench._timed_chain(jax, jax.jit(lambda c, v: c.step(v)), chain,
                              (x,), channels * block, n_steps, reps)


def ab(jax, jnp):
    cases = [
        ("config[0]", lambda b: bench.bench_fused_chain(jax, jnp, backend=b)),
        ("config[1]", lambda b: bench.bench_symsync(jax, jnp, backend=b)),
        ("config[3]", lambda b: bench.bench_qamrx(jax, jnp, backend=b)),
    ]
    for name, run in cases:
        got = defaultdict(list)
        for b in ("auto", "xla", "xla", "auto"):
            got[b].append(run(b)[0])
        k, x = np.mean(got["auto"]), np.mean(got["xla"])
        print(f"{name}: kernel {got['auto']} Msps, xla {got['xla']} Msps; "
              f"kernel/xla {k / x:.2f}x", flush=True)
        if name == "config[0]":
            r = [bench_rx_chain(jax, jnp)[0] for _ in range(2)]
            print(f"{name}: RxChain (three-stage xla) {r} Msps; kernel/RxChain "
                  f"{k / np.mean(r):.2f}x", flush=True)


def sweep(jax, jnp):
    """Symsync kernel alone: ms per 4096-sample block vs channels/program."""
    from yagi_tpu.design import FirFilterShape
    from yagi_tpu.filter import Symsync
    from yagi_tpu.kernels.symscan import symsync_scan

    for C in (1024, 2048):
        ss = Symsync.create_rnyquist(FirFilterShape.RRCOS, 2, 7, 0.3,
                                     batch_shape=(C,)).set_lf_bw(0.02)
        L, n = ss.mf.shape[1], 4096
        rng = np.random.default_rng(0)
        xr = jnp.asarray(rng.standard_normal((C, L + n)).astype(np.float32))
        xi = jnp.asarray(rng.standard_normal((C, L + n)).astype(np.float32))
        bank = jnp.concatenate([ss.mf, ss.dmf])
        state = jnp.zeros((9, C), jnp.float32).at[4].set(2.0).at[5].set(2.0)
        consts = jnp.zeros((5, C), jnp.float32).at[4].set(0.5)
        for bc in (1, 2, 4, 8, 16, 32):
            f = jax.jit(lambda a, b_: symsync_scan(
                a, b_, n, bank, state, consts, P=32, E=2, k_out=1, bc=bc))
            jax.block_until_ready(f(xr, xi))
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(f(xr, xi))
                ts.append(time.perf_counter() - t0)
            ms = float(np.median(ts)) * 1e3
            print(f"symsync kernel C={C} bc={bc}: {ms:.3f} ms/block "
                  f"({C * n / ms / 1e3:.1f} Msps), programs {-(-C // bc)}",
                  flush=True)


def trace(jax, jnp, out_dir, steps=20):
    """Device time per kernel of config[4]'s channelizer + FM step."""
    from yagi_tpu.multichannel import Firpfbch

    M, T = 64, 1 << 15
    x = jnp.asarray(bench._cplx(np.random.default_rng(1), T * M))
    step = jax.jit(bench.channelizer_fm_step)
    chz = Firpfbch.create_kaiser(M, 4, 60.0)
    jax.block_until_ready(step(chz, x))
    with jax.profiler.trace(out_dir):
        for _ in range(steps):
            fm, chz = step(chz, x)
        jax.block_until_ready(fm)
    paths = []
    for root, _, files in os.walk(out_dir):
        paths += [os.path.join(root, f) for f in files if f.endswith(".xplane.pb")]
    pd = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    for plane in pd.planes:
        if "GPU" not in plane.name:
            continue
        for line in plane.lines:
            tot = defaultdict(float)
            for ev in line.events:
                tot[ev.name] += ev.duration_ns
            if not tot:
                continue
            top = sorted(tot.items(), key=lambda kv: -kv[1])[:8]
            print(f"trace {plane.name} / {line.name}: total "
                  f"{sum(tot.values()) / steps / 1e3:.1f} us/step")
            for k, v in top:
                print(f"    {v / steps / 1e3:9.1f} us/step  {k[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--skip-ab", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from yagi_tpu.utils.compile_cache import enable_compile_cache

    require_gpu(jax)
    enable_compile_cache()
    print(f"{jax.devices()[0].device_kind} | {card_info()}", flush=True)
    if not args.skip_ab:
        ab(jax, jnp)
    if args.sweep:
        sweep(jax, jnp)
    if args.trace:
        trace(jax, jnp, args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
