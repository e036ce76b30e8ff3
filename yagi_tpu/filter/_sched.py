"""Static-schedule polyphase resampling as one banded matmul.

The rational resampler's emission schedule is static (rresamp.rs:144-160:
output j of a P-block consumes input floor(j·Q/P) through branch (j·Q) mod
P), and the arbitrary resampler's u32 schedule collapses to the same static
form whenever the reduced numerator P divides 2^24 (step·P = Q·2^24 exactly,
so the phase accumulator returns to its entry value every Q inputs —
resamp.rs:103,141-154).

This module lifts any static (src, branch) periodic schedule into the banded
matmul mapping of filter/_conv.py, in place of a dynamic frame gather: s
periods of outputs per ~128-sample row, window rows concatenated, taps
placed in a [K, W] band matrix G whose column j' = t·P + j holds branch[j]'s
taps at offset t·Q + src[j] — one dot per row instead of P·L gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_PREC = jax.lax.Precision.HIGHEST

# beyond this band height the matrix is mostly zeros (heavy decimation) and
# the strided-conv / gather forms are the right tool
_MAX_K = 4096


def sched_matmul_ok(p: int, q: int, sub_len: int) -> bool:
    """Would the banded form be sensible for this schedule?"""
    s = max(1, -(-128 // p))
    krow = s * q
    nband = 1 + max(0, -(-(sub_len - 1) // krow))
    return nband * krow <= _MAX_K


def sched_banded_matmul(
    xa: jnp.ndarray,
    branches: jnp.ndarray,
    src_off: np.ndarray,
    br_idx: np.ndarray,
    q: int,
    n_periods: int,
) -> jnp.ndarray:
    """Periodic static-schedule resample of ``xa`` → [..., n_periods·P].

    ``xa``: input incl. the (sub_len−1)-sample left history, laid out so that
    output j of period t reads ``xa[..., t·Q + src_off[j] : +sub_len]`` (the
    frame convention of resamp.py/rresamp.py). ``branches``: [npfb, sub_len]
    taps in convolution order (branches[b, 0] multiplies the newest sample of
    the frame). ``src_off``/``br_idx``: length-P host arrays.

    y[..., t·P + j] = Σ_l xa[..., t·Q+src_off[j]+l] · branches[br_idx[j], L−1−l]
    — identical math to the reference's per-emission dotprod, evaluated as
    one banded matmul per output row.
    """
    src_off = np.asarray(src_off, dtype=np.int64)
    br_idx = np.asarray(br_idx, dtype=np.int64)
    p = len(src_off)
    L = branches.shape[1]
    out_dtype = jnp.promote_types(xa.dtype, branches.dtype)
    xa = xa.astype(out_dtype)
    br = branches.astype(out_dtype)

    s = max(1, -(-128 // p))  # periods per output row
    W = s * p
    krow = s * q
    nband = 1 + max(0, -(-(L - 1) // krow))
    K = nband * krow
    n_rows = -(-n_periods // s)
    total = (n_rows - 1) * krow + K

    batch_shape = xa.shape[:-1]
    m0 = xa.shape[-1]
    xp = jnp.pad(xa.reshape((-1, m0)), ((0, 0), (0, total - m0)))
    x3 = xp.reshape((-1, n_rows - 1 + nband, krow))
    f = jnp.concatenate([x3[:, d : d + n_rows] for d in range(nband)], axis=-1)

    # band matrix G[u, j'] = br_rev[branch_j, u − (t·Q + src_off[j])]
    u = np.arange(K)[:, None]
    t = np.arange(W)[None, :] // p
    j = np.arange(W)[None, :] % p
    rel = u - (t * q + src_off[j])
    valid = (rel >= 0) & (rel < L)
    idx_m = (L - 1) - np.clip(rel, 0, L - 1)  # conv order: newest sample first
    idx_b = np.broadcast_to(br_idx[j], (K, W))
    g = jnp.where(
        jnp.asarray(valid),
        br[jnp.asarray(idx_b), jnp.asarray(idx_m)],
        jnp.zeros((), out_dtype),
    )
    y = jax.lax.dot_general(f, g, (((2,), (0,)), ((), ())), precision=_PREC)
    return y.reshape(batch_shape + (n_rows * W,))[..., : n_periods * p]


def u32_static_schedule(step: int, bits: int, npfb: int):
    """(P, Q, src_off, br_idx) of the u32 phase schedule, or None.

    The u32 accumulator (step = round(2^24/r), emit while phase ≤ 0xffffff,
    branch = top ``bits`` of the 24-bit phase — resamp.rs:103,141-154) is
    exactly periodic iff the reduced numerator P = 2^24/gcd(step, 2^24)
    satisfies step·P ≡ 0 (mod 2^24) — i.e. always, with P a power of two.
    Practical when P ≤ 256 (else the period outgrows a block).
    """
    import math

    step = int(step)
    if step == 0:
        return None
    g = math.gcd(step, 1 << 24)
    p = (1 << 24) // g
    q = step // g
    if p > 256:
        return None
    src_off = np.empty(p, dtype=np.int64)
    br_idx = np.empty(p, dtype=np.int64)
    for j in range(p):
        ph = j * step  # python int, exact
        src_off[j] = ph >> 24
        br_idx[j] = (ph >> (24 - bits)) & (npfb - 1)
    return p, q, src_off, br_idx
