"""Parallel linear-recurrence evaluation (log-depth all-pole filters).

An IIR filter's feedback path v0[n] = x[n] − Σₖ aₖ·v0[n−k] is a *linear*
time-invariant recurrence, so it need not run as a per-sample lax.scan
(iirfilt.rs:359-371 semantics): writing the order-m state
s[n] = [v0[n], …, v0[n−m+1]] gives s[n] = M·s[n−1] + e·x[n] with the
companion matrix M, and the affine maps (A, b) compose associatively:

    (A₂, b₂) ∘ (A₁, b₁) = (A₂A₁, A₂b₁ + b₂)

`jax.lax.associative_scan` evaluates all prefixes in O(log T) depth with
full vectorization, instead of a sequential scan of T tiny steps. The numerator (FIR) part is
applied afterwards as m+1 shifted adds on the v0 sequence.

Outputs match the sequential scan to fp32 tolerance (exact same recurrence,
different summation order); the sequential path remains the default for
bit-compatibility and is the oracle in tests/test_iir_parallel.py.

Numerical guard: the general-order path forms cumulative
companion-matrix products Mⁿ. For NORMAL/near-normal M with pole radius
r < 1 these stay bounded, but TF-form filters of order > 2 can have highly
non-normal companion matrices whose transients ‖Mⁿ‖ grow to ~κ·rⁿ with large
κ before decaying — fp32 can overflow or lose the answer where the
sequential scan would not. Callers should keep this path to order ≤ 2 (the
SOS pipeline guarantees that) or verify pole radius ≲ 0.99 at design time;
tests/test_iir_parallel.py includes an r=0.99 biquad parity case bounding
the error empirically. iir_design output is always SOS-cascaded biquads, so
the production path never composes higher-order companions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["allpole_parallel"]

_PREC = jax.lax.Precision.HIGHEST  # f32 products, never TF32 on the GPU


def _combine(left, right):
    """Compose affine recurrence elements (left happens first in time)."""
    a1, b1 = left
    a2, b2 = right
    a = jnp.einsum("t...ij,t...jk->t...ik", a2, a1, precision=_PREC)
    b = jnp.einsum("t...ij,t...j->t...i", a2, b1, precision=_PREC) + b2
    return a, b


def allpole_parallel(a_tail, v_init, x):
    """All-pole recurrence v0[n] = x[n] − Σₖ a_tail[k−1]·v0[n−k], log-depth.

    a_tail: [m] feedback taps (a₁…a_m, a₀ already normalized out);
    v_init:  [..., m] previous v0 values, newest first (the DF-II v-buffer);
    x:       [..., T] input block (time last).

    Returns (v0 [..., T], v_final [..., m]) — identical state convention to
    the sequential scan in IirFilter.execute_block.
    """
    m = int(a_tail.shape[0])
    T = x.shape[-1]
    dt = jnp.result_type(a_tail.dtype, x.dtype)
    x = x.astype(dt)
    xt = jnp.moveaxis(x, -1, 0)  # [T, ...]

    if m == 1:
        # scalar fast path: s[n] = p·s[n−1] + x[n]
        p = -a_tail[0]
        a_el = jnp.broadcast_to(p, (T,)).astype(dt)
        ones_tail = x.ndim - 1

        def comb(l, r):
            al, bl = l
            ar, br = r
            return al * ar, ar.reshape((-1,) + (1,) * ones_tail) * bl + br

        a_cum, b_cum = jax.lax.associative_scan(comb, (a_el, xt), axis=0)
        s0 = v_init[..., 0]
        v0t = a_cum.reshape((-1,) + (1,) * ones_tail) * s0[None] + b_cum
        v0 = jnp.moveaxis(v0t, 0, -1)
        return v0, v0[..., -1:]

    # companion matrix: first row −a, shifted identity below
    M = jnp.concatenate([-a_tail[None, :], jnp.eye(m, dtype=a_tail.dtype)[:-1]], 0)
    a_el = jnp.broadcast_to(M.astype(dt), (T, m, m))
    # b element: e₀·x[n] → [T, ..., m]
    b_el = jnp.concatenate(
        [xt[..., None], jnp.zeros(xt.shape + (m - 1,), dt)], axis=-1
    )
    a_cum, b_cum = jax.lax.associative_scan(_combine, (a_el, b_el), axis=0)
    # s[n] = A_cum[n]·s₀ + b_cum[n];  s₀ = v_init (already newest-first)
    s = jnp.einsum("tij,...j->t...i", a_cum, v_init.astype(dt),
                   precision=_PREC) + b_cum
    v0 = jnp.moveaxis(s[..., 0], 0, -1)  # [..., T]
    v_final = s[-1]  # [..., m] newest first
    return v0, v_final
