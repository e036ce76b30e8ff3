#!/usr/bin/env python
"""One process of a multi-host streaming run (CPU-testable).

Launched N times (once per "host") by tests/test_multihost.py with:
  MULTIHOST_COORD=127.0.0.1:<port> MULTIHOST_N=<n> MULTIHOST_ID=<i>
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=<d>

Each process contributes its local time block of a [ch, time] stream, the
global mesh spans all processes' devices, and `time_sharded_fir` runs with
ppermute halo exchange across the host boundary. Process 0 checks the
gathered result bit-for-bit against the single-process sequential reference
and prints MULTIHOST_OK.

This is the same wiring a multi-host GPU cluster uses (yagi_tpu/parallel/multihost.py);
on pods `initialize_multihost()` takes no arguments.
"""

import os
import sys

import numpy as np


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from yagi_tpu.parallel.multihost import (
        distribute_time_stream,
        gather_to_hosts,
        global_time_mesh,
        initialize_multihost,
    )
    from yagi_tpu.parallel import time_sharded_fir

    coord = os.environ["MULTIHOST_COORD"]
    n_proc = int(os.environ["MULTIHOST_N"])
    pid = int(os.environ["MULTIHOST_ID"])
    initialize_multihost(coord, n_proc, pid)

    mesh = global_time_mesh()
    n_time = mesh.shape["time"]

    # deterministic global stream, each process slices out its local block
    rng = np.random.default_rng(0)
    ch, L, n = 2, 33, n_time * 64
    h = rng.standard_normal(L).astype(np.float32)
    x = (rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n))).astype(
        np.complex64
    )
    per_proc = n // n_proc
    x_local = x[:, pid * per_proc : (pid + 1) * per_proc]

    xg = distribute_time_stream(x_local, mesh)
    y = jax.jit(lambda v: time_sharded_fir(h, v, mesh))(xg)
    y_all = gather_to_hosts(y)

    if pid == 0:
        import jax.numpy as jnp

        from yagi_tpu.filter import FirFilter

        f = FirFilter.create(h, batch_shape=(ch,), dtype=jnp.complex64)
        block = n // n_time
        parts = []
        for b in range(n_time):
            yb, f = f.execute_block(x[:, b * block : (b + 1) * block])
            parts.append(np.asarray(yb))
        np.testing.assert_array_equal(y_all, np.concatenate(parts, axis=-1))
        print(f"MULTIHOST_OK procs={n_proc} devices={len(jax.devices())} "
              f"local={len(jax.local_devices())}", flush=True)

    # ---- flagship 64-channel channelizer + all_to_all across hosts ------
    # (the collective that carries real volume crosses the process
    # boundary, not just the halo ppermute)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from yagi_tpu.multichannel import Firpfbch
    from yagi_tpu.parallel import sharded_channelize_to_channels

    M = 64
    chz = Firpfbch.create_kaiser(M, 4, 60.0)
    T = n_time * 24  # channelizer steps, one block of 24 per device
    xc = (rng.standard_normal(T * M) + 1j * rng.standard_normal(T * M)).astype(
        np.complex64
    )
    per = (T * M) // n_proc
    sharding = NamedSharding(mesh, P("time"))
    xg2 = jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(xc[pid * per : (pid + 1) * per])
    )
    y2 = jax.jit(lambda v: sharded_channelize_to_channels(chz, v, mesh))(xg2)
    y2_all = gather_to_hosts(y2)

    if pid == 0:
        y_ref, _ = chz.analyzer_execute(jnp.asarray(xc))
        y_ref = np.asarray(y_ref)
        assert y2_all.shape == y_ref.shape == (M, T)
        # bit-identical past the zero-state transient (step p)
        np.testing.assert_array_equal(y2_all[:, chz.p :], y_ref[:, chz.p :])
        print(f"MULTIHOST_CHANNELIZER_OK M={M} T={T} procs={n_proc}",
              flush=True)

    # ---- double-buffered pipelined B-block stream across hosts ----------
    # (the pipeline the weak-scaling story rests on crosses a real process
    # boundary — block t's all_to_all overlaps block
    # t+1's analyzer compute, with the FM discriminator memory carried
    # across blocks.)
    from yagi_tpu.parallel import sharded_channelize_stream_fm_to_channels

    B, kf = 3, 0.1
    xb = (rng.standard_normal((B, T * M)) + 1j *
          rng.standard_normal((B, T * M))).astype(np.complex64)
    perb = (T * M) // n_proc
    sh_b = NamedSharding(mesh, P(None, "time"))
    xg3 = jax.make_array_from_process_local_data(
        sh_b, np.ascontiguousarray(xb[:, pid * perb : (pid + 1) * perb])
    )
    m3 = jax.jit(
        lambda v: sharded_channelize_stream_fm_to_channels(chz, kf, v, mesh)
    )(xg3)
    m3_all = gather_to_hosts(m3)

    if pid == 0:
        y_ref3, _ = chz.analyzer_execute(jnp.asarray(xb.reshape(-1)))
        y_ext = jnp.concatenate(
            [jnp.zeros((M, 1), np.complex64), jnp.asarray(y_ref3)], axis=-1
        )
        # SAME elementwise device formula as the sharded path — exact
        ref_c = 1.0 / (2.0 * np.pi * kf)
        m_ref = np.asarray(
            jax.jit(
                lambda y: jnp.angle(jnp.conj(y[..., :-1]) * y[..., 1:])
                * jnp.float32(ref_c)
            )(y_ext)
        ).reshape(M, B, T).transpose(1, 0, 2)
        assert m3_all.shape == (B, M, T)
        p1 = chz.p + 1
        np.testing.assert_array_equal(m3_all[0][:, p1:], m_ref[0][:, p1:])
        np.testing.assert_array_equal(m3_all[1:], m_ref[1:])
        print(f"MULTIHOST_PIPELINED_STREAM_OK B={B} M={M} T={T} "
              f"procs={n_proc}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
