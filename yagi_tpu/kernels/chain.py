"""Fused receive-chain kernel: FIR → P× polyphase interpolator → NCO mix-down.

One pass over the input stream replaces the three-stage XLA chain
(BASELINE config[0]; reference semantics: firfilt.rs execute_block →
resamp.rs:141-154 u32-phase polyphase emission → osc.rs:179 block mix).
Every stage is a streaming operation of low arithmetic intensity, so the
XLA chain spends its time writing the FIR and resampler outputs to device
memory and reading them back; this kernel reads the input once and writes
the mixed P×-rate stream once.

* For an integer rate P (P | 2^24, P | npfb), the resampler's u32 phase
  schedule is static and periodic: output m consumes input n=m//P through
  branch (m%P)·(npfb/P), and the carried phase is always 0 — an exact
  specialization of resamp.rs:141-154 (step = 2^24/P).
* FIR ⊛ branch filters collapse into P combined filters g_δ = h_fir ⊛ h_branchδ
  (length 64+14-1 = 77 for the flagship), computed in f64 on the host.
* Each program owns one channel and one power-of-two tile of input samples
  and evaluates the P combined filters as a direct fp32 dot over the K taps
  (K·P multiply-adds per input sample and plane). It loads its own left
  halo: from ``x`` for every tile but the first, from the carried history
  for the first.
* The NCO phase ramp θ_m = θ0 + m·dθ is computed in wrapping uint32
  (osc.rs:86-88), exactly as ``Osc.mix_block_down``'s "exact" mode.

Complex I/O is planar (re/im planes): Pallas kernels take real dtypes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["HIST", "chain_taps", "chain_tile", "chain_reference",
           "fused_chain_apply"]

HIST = 128  # input history carried between blocks; bounds the filter length
# programs of ≤512 input samples and 4 warps: the fastest of tiles
# 256-4096 × 2-8 warps on the H100 (C=16, 131,072-sample blocks)
_MAX_TILE = 512
_NUM_WARPS = 4
_TWO_PI_U32 = np.float32(2.0 * np.pi / 4294967296.0)


def chain_taps(h, scale, branches, p: int) -> np.ndarray:
    """Combined filters, TAP-MAJOR ``[K, P]``: ``g[k, δ] = g_δ[k]``.

    ``h``: FIR taps (h[0] multiplies the newest sample), ``scale``: FIR
    output scale, ``branches``: [npfb, L] polyphase bank in convolution
    order (branch row b, tap j multiplies y0[n-j], cf. filter/resamp.py).
    g_δ = (scale·h) ⊛ branches[δ·npfb/P], computed in float64; output
    sample m = P·n + δ is Σ_k g_δ[k]·x[n-k].
    """
    h = np.asarray(h, dtype=np.float64) * float(np.asarray(scale).real)
    branches = np.asarray(branches, dtype=np.float64)
    npfb, L = branches.shape
    if npfb % p:
        raise ValueError("P must divide npfb")
    if (1 << 24) % p:
        raise ValueError("P must divide 2^24 for an exact static phase schedule")
    K = len(h) + L - 1
    if K > HIST:
        raise ValueError(f"combined filter length {K} exceeds the history ({HIST})")
    g = np.stack([np.convolve(h, branches[d * (npfb // p)]) for d in range(p)])
    return np.ascontiguousarray(g.T).astype(np.float32)


def chain_tile(t: int, k: int) -> int:
    """Input samples per program: the largest power of two ≤ 512 that
    divides the block length ``t`` and covers the filter length ``k`` (a
    tile's halo then lies inside the previous tile)."""
    tile = _MAX_TILE
    while tile >= k and t % tile:
        tile //= 2
    if t <= 0 or tile < k:
        raise ValueError(
            f"block length {t} has no power-of-two tile of at least {k} samples"
        )
    return tile


def _mix_down(zr, zi, m, theta0, dtheta):
    """(zr + j·zi)·exp(-j·θ_m) with θ_m = θ0 + m·dθ in wrapping uint32."""
    theta = theta0 + m.astype(jnp.uint32) * dtheta
    t = theta.astype(jnp.float32) * _TWO_PI_U32
    c = jnp.cos(t)
    s = jnp.sin(t)
    return zr * c + zi * s, zi * c - zr * s


def chain_reference(xr, xi, g, hist_r, hist_i, theta0, dtheta):
    """Plain XLA formulation of :func:`fused_chain_apply` (same math).

    One VALID correlation per plane over ``[history | block]`` at HIGHEST
    precision, interleaved to the P×-rate stream, then the exact NCO ramp.
    Returns ``(yr, yi)`` [C, T·P].
    """
    K, p = g.shape
    C, T = xr.shape
    rhs = jnp.transpose(g[::-1], (1, 0))[:, None, :]  # [P, 1, K] correlation

    def filt(x, hist):
        xa = jnp.concatenate([hist, x], axis=-1)[:, None, HIST - K + 1:]
        z = jax.lax.conv_general_dilated(
            xa, rhs, window_strides=(1,), padding="VALID",
            precision=jax.lax.Precision.HIGHEST,
        )  # [C, P, T]
        return jnp.transpose(z, (0, 2, 1)).reshape(C, T * p)

    m = jnp.arange(T * p, dtype=jnp.uint32)
    return _mix_down(filt(xr, hist_r), filt(xi, hist_i), m,
                     jnp.asarray(theta0, jnp.uint32),
                     jnp.asarray(dtheta, jnp.uint32))


def _chain_kernel(scal_ref, g_ref, xr_ref, xi_ref, hr_ref, hi_ref,
                  yr_ref, yi_ref, *, p: int, k: int, tile: int):
    """One program: channel ``program_id(1)``, input tile ``program_id(0)``.

    ``y[c, n, δ]`` for the tile's n: P one-dimensional accumulators per
    plane, one window load per tap and plane shared by the P filters.
    """
    t = pl.program_id(0)
    c = pl.program_id(1)
    n0 = t * tile
    iota = jnp.arange(tile, dtype=jnp.int32)

    def filt(window):
        def tap(j, acc):
            wr, wi = window(j)
            return tuple(
                (ar + wr * g_ref[j, d], ai + wi * g_ref[j, d])
                for d, (ar, ai) in enumerate(acc)
            )

        zero = jnp.zeros((tile,), jnp.float32)
        return jax.lax.fori_loop(0, k, tap, ((zero, zero),) * p)

    def body_window(j):
        # every tile but the first: x[n0 - j : n0 - j + tile], in bounds
        # because tile ≥ k > j
        return (xr_ref[c, pl.ds(n0 - j, tile)], xi_ref[c, pl.ds(n0 - j, tile)])

    def head_window(j):
        # first tile: samples before the block come from the history
        idx = iota - j
        inx = idx >= 0
        xi_ = jnp.maximum(idx, 0)
        hi_ = jnp.minimum(idx + HIST, HIST - 1)
        wr = (plgpu.load(xr_ref.at[c, xi_], mask=inx, other=0.0)
              + plgpu.load(hr_ref.at[c, hi_], mask=~inx, other=0.0))
        wi = (plgpu.load(xi_ref.at[c, xi_], mask=inx, other=0.0)
              + plgpu.load(hi_ref.at[c, hi_], mask=~inx, other=0.0))
        return wr, wi

    def emit(window):
        for d, (zr, zi) in enumerate(filt(window)):
            yr, yi = _mix_down(zr, zi, (n0 + iota) * p + d, scal_ref[0],
                               scal_ref[1])
            yr_ref[c, pl.ds(n0, tile), d] = yr
            yi_ref[c, pl.ds(n0, tile), d] = yi

    @pl.when(t == 0)
    def _():
        emit(head_window)

    @pl.when(t > 0)
    def _():
        emit(body_window)


@functools.partial(jax.jit, static_argnames=("interpret",))
def fused_chain_apply(xr, xi, g, hist_r, hist_i, theta0, dtheta, *,
                      interpret: bool = False):
    """Run the fused chain over planar blocks.

    xr/xi: [C, T] input planes (T a multiple of a power-of-two tile of at
    least K samples, :func:`chain_tile`); g: [K, P] from
    :func:`chain_taps`; hist_r/i: [C, 128] trailing input history of the
    previous block (zeros at stream start); theta0/dtheta: u32 NCO state.

    Returns (yr, yi) [C, T·P]. State advance (caller): hist' = x[:, -128:],
    theta' = theta0 + u32(T·P)·dtheta; the resampler phase is 0 before and
    after every block by construction.
    """
    K, p = g.shape
    C, T = xr.shape
    if hist_r.shape != (C, HIST) or hist_i.shape != (C, HIST):
        raise ValueError(f"history must be [{C}, {HIST}]")
    tile = chain_tile(T, K)
    scalars = jnp.stack([jnp.asarray(theta0, jnp.uint32),
                         jnp.asarray(dtheta, jnp.uint32)])
    kernel = functools.partial(_chain_kernel, p=p, k=K, tile=tile)
    out = jax.ShapeDtypeStruct((C, T, p), jnp.float32)
    yr, yi = pl.pallas_call(
        kernel,
        out_shape=(out, out),
        grid=(T // tile, C),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="fused_rx_chain",
    )(scalars, g, xr, xi, hist_r, hist_i)
    return yr.reshape(C, T * p), yi.reshape(C, T * p)
