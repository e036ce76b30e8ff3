"""Distributed channelizer: time-sharded polyphase analysis + per-channel demod.

BASELINE.json config[4]: the M-channel firpfbch channelizer with time-blocks
sharded across devices. Each device receives its contiguous time block plus a
p·M-sample halo from its left neighbor via ONE `ppermute`, runs the
local analyzer on [halo | block] with zero initial state, and drops the first
p output steps (which depended only on the halo) — classic overlap-save. The
retained outputs are bit-identical to a single-device run because the
analyzer state is a pure function of the last (p-1)·M + M-1 raw samples,
which the halo fully covers.

Per-channel demodulation (FM discriminator or linear modem decisions) is
embarrassingly parallel after analysis and stays device-local.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..multichannel import Firpfbch

__all__ = [
    "sharded_channelize",
    "sharded_channelize_fm",
    "sharded_channelize_to_channels",
    "sharded_channelize_fm_to_channels",
    "sharded_channelize_stream_to_channels",
    "sharded_channelize_stream_fm_to_channels",
]


def _local_analyze(ch: Firpfbch, halo_and_block: jnp.ndarray) -> jnp.ndarray:
    """Analyzer over [halo | block], dropping the halo-only output steps."""
    p = ch.p
    y, _ = ch.analyzer_execute(halo_and_block)
    return y[..., p:]


def sharded_channelize(ch: Firpfbch, x: jnp.ndarray, mesh: Mesh):
    """Channelize a time-sharded stream [T·M] over mesh axis 'time'.

    Returns channels [M, T] with the same values a single-device
    ``ch.analyzer_execute`` (zero initial state) would produce, except the
    first p output steps of the whole stream which are zero-state transients
    on both paths.
    """
    M = ch.num_channels
    p = ch.p
    halo = p * M

    def local(block):
        tail = block[..., block.shape[-1] - halo :]
        n_dev = jax.lax.axis_size("time")
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        recv = jax.lax.ppermute(tail, "time", perm)
        idx = jax.lax.axis_index("time")
        lead = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
        return _local_analyze(ch, jnp.concatenate([lead, block], axis=-1))

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P("time"),
        out_specs=P(None, "time"),
    )
    return fn(x)


def sharded_channelize_to_channels(ch: Firpfbch, x: jnp.ndarray, mesh: Mesh):
    """Time-sharded input → CHANNEL-sharded output via one ``all_to_all``.

    The stream arrives time-sharded (that is how samples show up from an
    antenna front-end); per-channel demodulation wants each channel's FULL
    time history on one device (feedback loops — symsync, PLL, AGC — are
    sequential in time). This is SURVEY.md §7 phase-5's channel↔time
    redistribution: each device channelizes its local time block (ppermute
    halo, overlap-save), then ONE ``jax.lax.all_to_all`` splits the
    M channels into n_dev groups and concatenates the time blocks, leaving
    device d with channels [d·M/n, (d+1)·M/n) over the whole stream.

    Returns [M, T] laid out channel-sharded (out_specs P('time', None) —
    the mesh axis now indexes channel groups). Bit-identical to the
    single-device analyzer from output step p onward (zero-state transients
    excluded, as in :func:`sharded_channelize`).
    """
    M = ch.num_channels
    p = ch.p
    halo = p * M

    def local(block):
        tail = block[..., block.shape[-1] - halo :]
        n_dev = jax.lax.axis_size("time")
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        recv = jax.lax.ppermute(tail, "time", perm)
        idx = jax.lax.axis_index("time")
        lead = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
        y = _local_analyze(ch, jnp.concatenate([lead, block], axis=-1))
        # redistribute: [M, t_loc] → [M/n_dev, t_loc·n_dev]
        return jax.lax.all_to_all(y, "time", split_axis=0, concat_axis=1, tiled=True)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P("time"),
        out_specs=P("time", None),
    )
    return fn(x)


def sharded_channelize_fm_to_channels(
    ch: Firpfbch, kf: float, x: jnp.ndarray, mesh: Mesh
):
    """Config[4] with channel-parallel demod: channelize (time-sharded) →
    ``all_to_all`` → FM-discriminate each channel group locally.

    Because each device holds its channels' full time history after the
    redistribution, the discriminator has no block seams at all — exact
    except the leading zero-state transient, with NO extra halo.
    """
    M = ch.num_channels
    p = ch.p
    halo = p * M
    ref = 1.0 / (2.0 * np.pi * kf)

    def local(block):
        tail = block[..., block.shape[-1] - halo :]
        n_dev = jax.lax.axis_size("time")
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        recv = jax.lax.ppermute(tail, "time", perm)
        idx = jax.lax.axis_index("time")
        lead = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
        y = _local_analyze(ch, jnp.concatenate([lead, block], axis=-1))
        yg = jax.lax.all_to_all(y, "time", split_axis=0, concat_axis=1, tiled=True)
        return jnp.angle(jnp.conj(yg[..., :-1]) * yg[..., 1:]) * jnp.float32(ref)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P("time"),
        out_specs=P("time", None),
    )
    return fn(x)


def _stream_local_pipeline(ch: Firpfbch, demod=None):
    """Shard-map body for the double-buffered streaming channelizer.

    Software pipeline over a [B, t_loc] sequence of local time blocks:
    iteration i ISSUES block i−1's ``all_to_all`` (operand is the loop
    carry) and COMPUTES block i's halo + branch-FIR + IDFT — the two have
    no data dependence, so XLA's latency-hiding scheduler can run the
    collective's start→done window concurrently with the analyzer compute
    (tests/test_parallel.py checks the traced program's structure). Overlap
    is then not an assumption about XLA's treatment of one monolithic
    block, it is the shape of the program; whether NVLink hides the
    collective on the GPU is not measured.

    Halo continuity across the stream: device d's block-i halo is the tail
    of device d−1's block i (same iteration); device 0's halo is the tail
    of device n−1's block i−1, carried across the iteration boundary — ONE
    cyclic ppermute per block sends ``where(idx == n−1, carried_tail,
    current_tail)``. Stream start is zero state, matching the
    single-device analyzer.
    """
    M = ch.num_channels
    p = ch.p
    halo = p * M

    def local(blks):
        n_dev = jax.lax.axis_size("time")
        idx = jax.lax.axis_index("time")
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

        def tail_of(blk):
            return blk[..., blk.shape[-1] - halo:]

        def analyze_one(blk, carry_tail):
            send = jnp.where(idx == n_dev - 1, carry_tail, tail_of(blk))
            lead = jax.lax.ppermute(send, "time", perm)
            y, _ = ch.analyzer_execute(jnp.concatenate([lead, blk], axis=-1))
            return y[..., p:], tail_of(blk)

        def redistribute(y):
            return jax.lax.all_to_all(
                y, "time", split_axis=0, concat_axis=1, tiled=True
            )

        y0, tail0 = analyze_one(blks[0], jnp.zeros_like(tail_of(blks[0])))
        dstate0 = None
        if demod is not None:
            dstate0 = demod.init(y0)

        def step(carry, blk):
            pending, prev_tail, dstate = carry
            # collective for the PREVIOUS block — operand is the carry, so
            # it does not depend on this iteration's analyzer compute
            out_prev = redistribute(pending)
            if demod is not None:
                out_prev, dstate = demod.apply(out_prev, dstate)
            y, new_tail = analyze_one(blk, prev_tail)
            return (y, new_tail, dstate), out_prev

        (last_y, _, dstate), outs = jax.lax.scan(
            step, (y0, tail0, dstate0), blks[1:]
        )
        out_last = redistribute(last_y)
        if demod is not None:
            out_last, _ = demod.apply(out_last, dstate)
        return jnp.concatenate([outs, out_last[None]], axis=0)

    return local


def sharded_channelize_stream_to_channels(
    ch: Firpfbch, blocks: jnp.ndarray, mesh: Mesh
):
    """Double-buffered streaming channelizer (BASELINE config[4] structure).

    ``blocks``: [B, T] — B consecutive time blocks of one continuous
    stream, each time-sharded over mesh axis 'time'. Returns [B, M, T/M]
    channel-sharded analyzer outputs, bit-identical to the single-device
    ``ch.analyzer_execute`` over the concatenated stream (past the global
    zero-state transient, as :func:`sharded_channelize`), with block t's
    ``all_to_all`` overlapping block t+1's analyzer compute (see
    :func:`_stream_local_pipeline`).
    """
    fn = jax.shard_map(
        _stream_local_pipeline(ch),
        mesh=mesh,
        in_specs=P(None, "time"),
        out_specs=P(None, "time", None),
    )
    return fn(blocks)


class _FmDemod:
    """Per-channel FM discriminator with cross-block memory (config[4])."""

    def __init__(self, kf: float):
        self.ref = 1.0 / (2.0 * np.pi * kf)

    def init(self, y0):
        # discriminator memory: last channel sample of the PREVIOUS block,
        # in the post-all_to_all channel-group layout. Derived from y0 (not
        # a fresh jnp.zeros) so the shard_map varying-manual-axes type
        # matches the per-device value returned by apply().
        n = jax.lax.axis_size("time")
        return jnp.zeros_like(y0[: y0.shape[0] // n, :1])

    def apply(self, yg, prev):
        yx = jnp.concatenate([prev, yg], axis=-1)
        m = jnp.angle(jnp.conj(yx[..., :-1]) * yx[..., 1:]) * jnp.float32(
            self.ref
        )
        return m, yg[..., -1:]


def sharded_channelize_stream_fm_to_channels(
    ch: Firpfbch, kf: float, blocks: jnp.ndarray, mesh: Mesh
):
    """Streaming config[4]: pipelined channelize → all_to_all → FM demod.

    As :func:`sharded_channelize_stream_to_channels` but each redistributed
    block is FM-discriminated in place (device-local, channel-sharded) with
    the one-sample discriminator memory carried across blocks — the first
    output sample of the whole stream uses zero memory, every later block
    boundary is seamless.
    """
    fn = jax.shard_map(
        _stream_local_pipeline(ch, demod=_FmDemod(kf)),
        mesh=mesh,
        in_specs=P(None, "time"),
        out_specs=P(None, "time", None),
    )
    return fn(blocks)


def sharded_channelize_fm(ch: Firpfbch, kf: float, x: jnp.ndarray, mesh: Mesh):
    """Config[4] workload: channelize + per-channel FM discriminator.

    The FM discriminator m[n] = arg(conj(y[n-1])·y[n])/(2π·kf) needs one
    previous channel sample, so this path uses a one-step-larger halo of
    (p+1)·M samples: retained steps start at p+1 with the exact step p kept
    as the discriminator's memory. No second collective is needed.
    """
    M = ch.num_channels
    p = ch.p
    halo = (p + 1) * M
    ref = 1.0 / (2.0 * np.pi * kf)

    def local(block):
        tail = block[..., block.shape[-1] - halo :]
        n_dev = jax.lax.axis_size("time")
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        recv = jax.lax.ppermute(tail, "time", perm)
        idx = jax.lax.axis_index("time")
        lead = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
        y, _ = ch.analyzer_execute(jnp.concatenate([lead, block], axis=-1))
        # steps p..: exact; keep step p as the discriminator's memory sample
        yk = y[..., p:]
        m = jnp.angle(jnp.conj(yk[..., :-1]) * yk[..., 1:]) * jnp.float32(ref)
        return m

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P("time"),
        out_specs=P(None, "time"),
    )
    return fn(x)
