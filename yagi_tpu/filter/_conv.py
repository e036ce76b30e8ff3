"""Batched causal convolution primitives shared by the streaming filters.

These map the per-sample dotprod hot loop of the reference
(/root/reference/src/dotprod/mod.rs:19-121, firfilt.rs:241-245) onto XLA's
dense matmuls and conv_general_dilated at HIGHEST precision. All streaming
filters operate on the LAST axis with arbitrary leading batch/channel dims.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_PREC = jax.lax.Precision.HIGHEST


def result_dtype(x_dtype, h_dtype):
    """Promotion rule matching liquid's rrrf/crcf/cccf type algebra."""
    return jnp.promote_types(x_dtype, h_dtype)


_ROW = 128  # output samples per banded-matmul row
# Beyond this, FftFilt (overlap-add) is the right tool. Note the banded form
# materializes the window tensor F at nband ≈ ceil(L/128)+1 times the input
# size (~9x for L near the cutoff); if working-set pressure shows up for
# very long stride-1 FIRs on large blocks, lower this cutoff or route
# L > ~256 through FftFilt instead.
_MM_MAX_TAPS = 1024


def _banded_matmul_conv(xa: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Stride-1 causal conv as ONE dense matmul against a banded tap matrix.

    A conv with one input/output feature has no matmul structure for the
    compiler to exploit; this form hands it one dense matmul instead. Views
    the stream as 128-sample rows; each output row is the concatenated
    [row | next nband−1 rows] window times G[u, t] = h[t + L − 1 − u].
    """
    L = h.shape[0]
    out_dtype = result_dtype(xa.dtype, h.dtype)
    xa = xa.astype(out_dtype)
    h = h.astype(out_dtype)

    batch_shape = xa.shape[:-1]
    m = xa.shape[-1]
    n_out = m - L + 1
    nb = -(-n_out // _ROW)
    nband = -(-(L + _ROW - 1) // _ROW)
    K = nband * _ROW
    total = (nb - 1) * _ROW + K

    xp = jnp.pad(xa.reshape((-1, m)), ((0, 0), (0, total - m)))
    x3 = xp.reshape((-1, nb - 1 + nband, _ROW))
    # F[b] = [row b | row b+1 | … | row b+nband−1]  → [B, nb, K]
    f = jnp.concatenate([x3[:, d : d + nb] for d in range(nband)], axis=-1)

    u = jnp.arange(K)[:, None]
    t = jnp.arange(_ROW)[None, :]
    k = t + (L - 1) - u  # tap index feeding output lane t from window pos u
    g = jnp.where(
        (k >= 0) & (k < L), jnp.take(h, jnp.clip(k, 0, L - 1)), jnp.zeros((), out_dtype)
    )
    y = jax.lax.dot_general(
        f, g, (((2,), (0,)), ((), ())), precision=_PREC
    )  # [B, nb, 128]
    return y.reshape(batch_shape + (nb * _ROW,))[..., :n_out]


def causal_conv_valid(xa: jnp.ndarray, h: jnp.ndarray, stride: int = 1) -> jnp.ndarray:
    """y[..., n] = Σ_k h[k] · xa[..., n·stride + L - 1 - k].

    ``xa`` already includes the L-1 history samples on the left, so this is a
    VALID correlation with the flipped kernel — exactly the reference's
    window·h dotprod per output sample (firfilt.rs:241). Stride-1 filters of
    practical length run as a banded matmul (see _banded_matmul_conv);
    strided (decimating) and very long filters keep the conv formulation.
    """
    h = jnp.asarray(h)
    L = h.shape[0]
    if stride == 1 and 1 < L <= _MM_MAX_TAPS:
        return _banded_matmul_conv(xa, h)
    out_dtype = result_dtype(xa.dtype, h.dtype)
    xa = xa.astype(out_dtype)
    hk = h.astype(out_dtype)[::-1]

    batch_shape = xa.shape[:-1]
    m = xa.shape[-1]
    lhs = xa.reshape((-1, 1, m))
    rhs = hk.reshape((1, 1, L))
    y = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(stride,),
        padding="VALID",
        precision=_PREC,
    )
    n_out = y.shape[-1]
    return y.reshape(batch_shape + (n_out,))


def banded_branch_matrix(branches: np.ndarray, row: int | None = None
                         ) -> np.ndarray:
    """Host-side band matrix G for :func:`multi_branch_conv_tm_pre`.

    G[u, t·M + i] = branches[i, t + L − 1 − u] (zero outside [0, L)). Build
    ONCE at object-creation time: constructing it in-graph from a traced
    branches array is a ~2M-element gather per call.

    ``row`` is the output row-block size. Default: 64 for short banks
    (L ≤ 65 → band depth K = 128) and 128 otherwise — a 128 row block
    rounds K to 256 for a 29-tap bank, paying 2× the MACs of the K=128 form
    at identical accuracy.
    """
    branches = np.asarray(branches)
    M, L = branches.shape
    if row is None:
        row = 64 if L <= 65 else _ROW
    nband = -(-(L + row - 1) // row)
    K = nband * row
    u = np.arange(K)[:, None, None]
    t = np.arange(row)[None, :, None]
    i = np.arange(M)[None, None, :]
    k = t + (L - 1) - u
    g = np.where(
        (k >= 0) & (k < L), branches[i, np.clip(k, 0, L - 1)], 0.0
    ).reshape(K, row * M)
    return g.astype(branches.dtype)


def multi_branch_conv_tm_pre(xa: jnp.ndarray, g: jnp.ndarray, M: int, L: int
                             ) -> jnp.ndarray:
    """Time-major all-branch conv against a PREBUILT band matrix.

    Same result as :func:`multi_branch_conv_tm`(xa, branches) with
    ``g = banded_branch_matrix(branches)``; the band matrix comes from the
    caller's state instead of being gathered per call.
    """
    out_dtype = result_dtype(xa.dtype, g.dtype)
    xa = xa.astype(out_dtype)
    g = g.astype(out_dtype)
    batch_shape = xa.shape[:-1]
    m = xa.shape[-1]
    n_out = m - L + 1
    row = g.shape[1] // M  # output row-block of the prebuilt band matrix
    nb = -(-n_out // row)
    K = g.shape[0]
    total = (nb - 1) * row + K
    xp = jnp.pad(xa.reshape((-1, m)), ((0, 0), (0, total - m)))
    x3 = xp.reshape((-1, nb - 1 + K // row, row))
    f = jnp.concatenate([x3[:, d : d + nb] for d in range(K // row)], axis=-1)
    y = jax.lax.dot_general(f, g, (((2,), (0,)), ((), ())), precision=_PREC)
    return y.reshape(batch_shape + (nb * row, M))[..., :n_out, :]


def multi_branch_conv_tm(xa: jnp.ndarray, branches: jnp.ndarray) -> jnp.ndarray:
    """All-branch polyphase convolution, TIME-MAJOR output [..., N, M].

    Same math as :func:`multi_branch_conv` but returns the banded-matmul
    result in its NATURAL layout (output position major, branch minor) —
    the reshape is free, so no minor-axis transpose is ever materialized.
    This is the right form to feed time-scanned feedback loops (symsync),
    which read one time step of all branches at a time.
    """
    branches = jnp.asarray(branches)
    M, L = branches.shape
    out_dtype = result_dtype(xa.dtype, branches.dtype)
    if L <= _MM_MAX_TAPS and M <= 128:
        xa = xa.astype(out_dtype)
        br = branches.astype(out_dtype)
        batch_shape = xa.shape[:-1]
        m = xa.shape[-1]
        n_out = m - L + 1
        nb = -(-n_out // _ROW)
        nband = -(-(L + _ROW - 1) // _ROW)
        K = nband * _ROW
        total = (nb - 1) * _ROW + K
        xp = jnp.pad(xa.reshape((-1, m)), ((0, 0), (0, total - m)))
        x3 = xp.reshape((-1, nb - 1 + nband, _ROW))
        f = jnp.concatenate([x3[:, d : d + nb] for d in range(nband)], axis=-1)
        u = jnp.arange(K)[:, None, None]
        t = jnp.arange(_ROW)[None, :, None]
        i = jnp.arange(M)[None, None, :]
        k = t + (L - 1) - u
        g = jnp.where(
            (k >= 0) & (k < L),
            br[i, jnp.clip(k, 0, L - 1)],
            jnp.zeros((), out_dtype),
        ).reshape(K, _ROW * M)
        y = jax.lax.dot_general(f, g, (((2,), (0,)), ((), ())), precision=_PREC)
        return y.reshape(batch_shape + (nb * _ROW, M))[..., :n_out, :]
    return jnp.swapaxes(multi_branch_conv(xa, branches), -1, -2)


def multi_branch_conv(xa: jnp.ndarray, branches: jnp.ndarray) -> jnp.ndarray:
    """All-branch polyphase convolution.

    ``branches`` is [M, Lsub] with branch i's taps in convolution order
    (branches[i, 0] multiplies the newest sample). Returns [..., M, N] where
    out[..., i, n] = Σ_j branches[i, j] · xa[..., n + Lsub - 1 - j] — i.e.
    the reference's FirPfbFilter::execute(i) for every branch at once
    (firpfb.rs:277-286).
    """
    branches = jnp.asarray(branches)
    M, L = branches.shape
    out_dtype = result_dtype(xa.dtype, branches.dtype)
    if L <= _MM_MAX_TAPS and M <= 32:
        # banded-matmul form with branch-interleaved output columns
        # (c = t·M + i)
        xa = xa.astype(out_dtype)
        br = branches.astype(out_dtype)
        batch_shape = xa.shape[:-1]
        m = xa.shape[-1]
        n_out = m - L + 1
        nb = -(-n_out // _ROW)
        nband = -(-(L + _ROW - 1) // _ROW)
        K = nband * _ROW
        total = (nb - 1) * _ROW + K
        xp = jnp.pad(xa.reshape((-1, m)), ((0, 0), (0, total - m)))
        x3 = xp.reshape((-1, nb - 1 + nband, _ROW))
        f = jnp.concatenate([x3[:, d : d + nb] for d in range(nband)], axis=-1)
        u = jnp.arange(K)[:, None, None]
        t = jnp.arange(_ROW)[None, :, None]
        i = jnp.arange(M)[None, None, :]
        k = t + (L - 1) - u
        g = jnp.where(
            (k >= 0) & (k < L),
            br[i, jnp.clip(k, 0, L - 1)],
            jnp.zeros((), out_dtype),
        ).reshape(K, _ROW * M)
        y = jax.lax.dot_general(f, g, (((2,), (0,)), ((), ())), precision=_PREC)
        y = y.reshape(batch_shape + (nb * _ROW, M))[..., :n_out, :]
        return jnp.moveaxis(y, -1, -2)  # [..., M, N]
    xa = xa.astype(out_dtype)
    rhs = branches.astype(out_dtype)[:, ::-1].reshape((M, 1, L))

    batch_shape = xa.shape[:-1]
    m = xa.shape[-1]
    lhs = xa.reshape((-1, 1, m))
    y = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding="VALID",
        precision=_PREC,
    )  # [B, M, N]
    n_out = y.shape[-1]
    return y.reshape(batch_shape + (M, n_out))


def frame_gather(xa: jnp.ndarray, starts: jnp.ndarray, length: int) -> jnp.ndarray:
    """Gather frames xa[..., s : s+length] for each start s.

    Returns [..., len(starts), length]. Used where output positions are
    data-dependent (arbitrary resampler branch select, resamp.rs:141-154).
    """
    idx = starts[:, None] + jnp.arange(length)[None, :]
    return xa[..., idx]


def np_taps(h) -> np.ndarray:
    """Coerce host-side design output to a float32/complex64 numpy array."""
    h = np.asarray(h)
    if np.iscomplexobj(h):
        return h.astype(np.complex64)
    return h.astype(np.float32)
