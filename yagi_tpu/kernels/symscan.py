"""Symbol-synchronizer feedback loop as one Triton kernel (symsync.rs:230-266).

The XLA formulation (``filter/symsync.execute_slots(backend="xla")``) runs
the per-sample control loop as a ``lax.scan`` over the block: on the GPU
every iteration is at least one kernel launch, for a body of a few dozen
small vector operations. Here each program owns a block of channels and
runs the WHOLE time loop itself, with the loop state in registers:

* per input sample it loads the window of the last L samples of each of
  its channels (one row per channel, L padded to a power of two);
* per emission slot it gathers the selected branch's matched and
  derivative taps for each channel (a per-lane gather from the [2P, L]
  bank, which stays in L1) and forms the four dots re·mf, im·mf, re·dmf,
  im·dmf — 4·L multiply-adds instead of the all-branch 4·P·L;
* the loop filter, timing update and bounded emission unroll follow
  ``filter/symsync._emit_sample`` step for step, in f32.

The dots sum the taps in another order than the XLA banded matmul, so the
two formulations agree to float tolerance; the emission schedule is
identical. Channels are independent, so the wrapper pads the batch to a
whole number of programs and slices it back.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["NSTATE", "supported", "channel_block", "symsync_scan"]

NSTATE = 9  # state rows: b, bf, tau, tau_d, rate, delta, dec, pv0, pv1
_MAX_TAPS = 64


def supported(batch_shape: tuple, taps: int) -> bool:
    """Shapes the kernel runs: one channel axis and at most 64 taps a branch."""
    return len(batch_shape) == 1 and batch_shape[0] > 0 and taps <= _MAX_TAPS


def channel_block(c: int) -> int:
    """Channels per program: a power of two in [1, 4] that keeps at least
    512 programs. The loop is latency-bound, so each program's step costs
    about the same for 1-4 channels and grows past that (H100 sweep at
    C=1024 and 2048: 2 and 4 channels per program were fastest)."""
    bc = 1
    while bc < 4 and c >= 2 * bc * 512:
        bc *= 2
    return bc


def _round_half_even(v):
    """``jnp.round`` (half to even) from floor, for lowerings without round."""
    f = jnp.floor(v)
    d = v - f
    odd = (f - 2.0 * jnp.floor(0.5 * f)) != 0.0
    return jnp.where((d > 0.5) | ((d == 0.5) & odd), f + 1.0, f)


def _kernel(nv_ref, xr_ref, xi_ref, g_ref, st_ref, cst_ref, y_ref, so_ref,
            *, P: int, L: int, lpad: int, E: int, k_out: int, n: int, bc: int):
    c0 = pl.program_id(0) * bc
    cs = pl.ds(c0, bc)
    rows = (c0 + jnp.arange(bc, dtype=jnp.int32))[:, None]  # [bc, 1]
    cols = jnp.arange(lpad, dtype=jnp.int32)[None, :]  # [1, lpad]
    tap_ok = jnp.broadcast_to(cols < L, (bc, lpad))
    n_valid = nv_ref[0]

    locked = cst_ref[0, cs]
    radj = cst_ref[1, cs]
    pa1 = cst_ref[2, cs]
    pb0 = cst_ref[3, cs]
    kinv = cst_ref[4, cs]
    notlocked = locked < 0.5

    def taps(row):  # [bc] branch rows → [bc, lpad] taps (per-lane gather)
        idx = row.astype(jnp.int32)[:, None] * lpad + cols
        return g_ref[idx]

    def body(t, carry):
        (b, bf, tau, tau_d, rate, delta, dec, pv0, pv1) = carry
        vs = t < n_valid
        # window of sample t: xa[t + 1 + i], i < L (xa = [history | block])
        wcol = jnp.minimum(t + 1 + cols, n + L - 1)
        wr = plgpu.load(xr_ref.at[rows, wcol], mask=tap_ok, other=0.0)
        wi = plgpu.load(xi_ref.at[rows, wcol], mask=tap_ok, other=0.0)
        for e in range(E):
            active = (b < P) & vs
            bb = jnp.clip(b, 0.0, P - 1.0)
            gm = taps(bb)
            gd = taps(bb + P)
            mr = jnp.sum(gm * wr, axis=1)
            mi = jnp.sum(gm * wi, axis=1)
            dr = jnp.sum(gd * wr, axis=1)
            di = jnp.sum(gd * wi, axis=1)

            if k_out == 1:
                do_t = (dec == 1.0) & active & notlocked
            else:
                do_t = (dec == float(k_out)) & active & notlocked
                dec = jnp.where((dec == float(k_out)) & active, 0.0, dec)

            q = jnp.clip(mr * dr + mi * di, -1.0, 1.0)
            v0 = q - pa1 * pv0
            q_hat = pb0 * v0
            rate_new = rate + radj * q_hat
            delta_new = rate_new + q_hat

            pv1 = jnp.where(do_t, pv0, pv1)
            pv0 = jnp.where(do_t, v0, pv0)
            rate = jnp.where(do_t, rate_new, rate)
            delta = jnp.where(do_t, delta_new, delta)
            tau_d = jnp.where(do_t, tau, tau_d)

            if k_out == 1:
                dec = jnp.where(active, 1.0, dec)
            else:
                dec = jnp.where(active, dec + 1.0, dec)
            tau = jnp.where(active, tau + delta, tau)
            bf = jnp.where(active, tau * P, bf)
            b = jnp.where(active, _round_half_even(bf), b)
            # rows [yr slots | yi slots | valid slots], channels minor
            y_ref[t, e, cs] = jnp.where(active, mr * kinv, 0.0)
            y_ref[t, E + e, cs] = jnp.where(active, mi * kinv, 0.0)
            y_ref[t, 2 * E + e, cs] = active.astype(jnp.float32)

        vsf = vs.astype(jnp.float32)
        return (b - vsf * P, bf - vsf * P, tau - vsf, tau_d, rate, delta,
                dec, pv0, pv1)

    carry = jax.lax.fori_loop(
        0, n, body, tuple(st_ref[r, cs] for r in range(NSTATE)))
    for r in range(NSTATE):
        so_ref[r, cs] = carry[r]


@functools.partial(
    jax.jit, static_argnames=("P", "E", "k_out", "bc", "interpret"))
def symsync_scan(xr, xi, n_valid, bank, state, consts, *, P: int, E: int,
                 k_out: int, bc: int = 0, interpret: bool = False):
    """Run the symsync control loop over one block.

    ``xr``/``xi``: [C, L + n] planes of ``[history | block]`` (history =
    the object's L-sample window); ``n_valid``: scalar count of valid
    samples (``n`` when every sample counts); ``bank``: [2P, L] taps
    ``[mf; dmf]`` in convolution order; ``state``: [9, C] f32 rows (b, bf,
    tau, tau_d, rate, delta, dec, pv0, pv1); ``consts``: [5, C] f32 rows
    (locked, radj, pa1, pb0, 1/k). Returns ``(ys [n, 3E, C], state')``
    with ``ys`` rows ``[yr slots | yi slots | valid slots]``.
    """
    C, m = xr.shape
    twoP, L = bank.shape
    n = m - L
    if twoP != 2 * P or L > _MAX_TAPS:
        raise ValueError(f"bank must be [2P, ≤{_MAX_TAPS}], got {bank.shape}")
    bc = bc or channel_block(C)
    cp = -(-C // bc) * bc
    if cp != C:  # channels are independent: edge-pad to whole programs
        pad = lambda v: jnp.pad(v, [(0, cp - C), (0, 0)], mode="edge")  # noqa: E731
        xr, xi = pad(xr), pad(xi)
        state, consts = pad(state.T).T, pad(consts.T).T
    lpad = max(2, 1 << (L - 1).bit_length())
    # g[r, i] = bank[r, L-1-i]: window position i (oldest first) meets the
    # tap of lag L-1-i; zero columns pad L to a power of two
    g = jnp.pad(bank[:, ::-1], [(0, 0), (0, lpad - L)]).reshape(-1)
    nv = jnp.reshape(jnp.asarray(n_valid, jnp.int32), (1,))
    kern = functools.partial(_kernel, P=P, L=L, lpad=lpad, E=E,
                             k_out=k_out, n=n, bc=bc)
    ys, st = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct((n, 3 * E, cp), jnp.float32),
                   jax.ShapeDtypeStruct((NSTATE, cp), jnp.float32)),
        grid=(cp // bc,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="symsync_scan",
    )(nv, xr, xi, g, state, consts)
    return ys[..., :C], st[:, :C]
