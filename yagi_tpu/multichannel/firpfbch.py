"""Polyphase filter bank channelizer (analysis / synthesis).

No yagi implementation exists (src/multichannel/mod.rs is an empty stub,
SURVEY.md §2.6) — built from the liquid-dsp algorithm: commutator →
per-branch FIR → M-point (I)FFT. This is the centerpiece workload of
BASELINE.json configs[4].

Analysis math (critically sampled, M channels, decimation M):
  channel k at output step n equals mix-down by k/M → lowpass h → keep every
  M-th sample:
    y_k[n] = Σ_j h[j]·x[nM-j]·e^{+j2πkj/M}
           = Σ_b e^{+j2πkb/M} · u_b[n],   u_b[n] = Σ_p h[b+pM]·x[(n-p)M-b]
  i.e. branch b FIR-filters the delayed decimated stream s_b[i] = x[iM-b],
  and an unnormalized inverse DFT across branches yields the channels. The
  M branch filters run as p shifted multiply-adds fused into one pass, and
  the DFT across branches is one matmul (or batched FFT for M > 128).

Synthesis is the dual: unnormalized IDFT across channels → branch FIRs →
commutate into the output stream. Analysis→synthesis reconstructs the input
up to the prototype's distortion and delay.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from .. import design
from ..filter.firpfb import pfb_decompose

__all__ = ["Firpfbch", "Firpfbch2"]


def _grouped_branch_conv(xb: jnp.ndarray, branches: jnp.ndarray) -> jnp.ndarray:
    """Per-branch causal FIR: xb [..., M, N+p-1] (left context included),
    branches [M, p] in conv order → [..., M, N].

    Written as p shifted fused multiply-adds (the per-branch taps broadcast
    over time) rather than a depthwise grouped conv: pure elementwise work
    that XLA fuses into one pass.
    """
    M, p = branches.shape
    n = xb.shape[-1] - (p - 1)
    br = jnp.asarray(branches)
    acc = None
    for j in range(p):
        # tap j multiplies the sample j steps back: s[b, i-j] = xb[b, p-1+i-j]
        seg = xb[..., p - 1 - j : p - 1 - j + n]
        term = br[:, j, None] * seg
        acc = term if acc is None else acc + term
    return acc


def _idft_matrix(M: int) -> np.ndarray:
    """Unnormalized inverse-DFT matrix W[b, k] = exp(+2πi·bk/M)/M."""
    b = np.arange(M)
    return np.exp(2j * np.pi * np.outer(b, b) / M).astype(np.complex64) / M


def _idft(u: jnp.ndarray, axis_m: int) -> jnp.ndarray:
    """IDFT over axis -2 of [..., M, N]: one HIGHEST-precision matmul for
    small M (no transposes of the complex array), jnp.fft.ifft beyond 128
    channels."""
    M = u.shape[-2]
    if M <= 128:
        w = jnp.asarray(_idft_matrix(M))
        return jnp.einsum(
            "bk,...bn->...kn", w, u, precision=jax.lax.Precision.HIGHEST
        )
    return jnp.fft.ifft(u, axis=-2)


def _sliding_residue_conv(xa: jnp.ndarray, branches, P: int) -> jnp.ndarray:
    """c_r[t] = Σ_q h[r+qM]·xa[e_t − r − qM] for every step t and residue r,
    with e_t = (L−2) + (t+1)·P, as ONE strided VALID convolution.

    Replaces the [T, L] frame gather used by the sliding-transform
    channelizers (Firpfbch2 / Firpfbchr): residue r's taps become a dense
    length-L filter F_r[j] = h[j]·[j≡r (M)], all M filters share one
    alignment (lhs offset P−1), and XLA runs one strided multi-filter conv.
    """
    branches = np.asarray(branches)
    M, p = branches.shape
    L = p * M
    jj = np.arange(L)
    h_tap = branches[jj % M, jj // M]  # h[j]
    F = np.zeros((M, L), branches.dtype)
    F[jj % M, jj] = h_tap
    rhs = jnp.asarray(F[:, ::-1].astype(np.float32)).astype(jnp.complex64)

    batch_shape = xa.shape[:-1]
    lhs = xa[..., P - 1 :].reshape((-1, 1, xa.shape[-1] - (P - 1)))
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs.reshape(M, 1, L),
        window_strides=(P,),
        padding="VALID",
        precision=jax.lax.Precision.HIGHEST,
    )  # [B, M, T]
    c = jnp.swapaxes(out, -1, -2)  # [B, T, M]
    return c.reshape(batch_shape + c.shape[1:])


def _design_prototype(num_channels: int, m: int, as_: float) -> np.ndarray:
    h_len = 2 * num_channels * m + 1
    h = design.fir_design_kaiser(h_len, 0.5 / num_channels, as_, 0.0)
    return h[: h_len - 1]  # length 2·M·m


@struct.pytree
class Firpfbch:
    """Critically-sampled M-channel analysis/synthesis bank.

    State: per-branch stream history [..., M, p-1] plus the raw M-1 input
    tail (needed to form cross-block branch samples x[iM-b]).
    """

    num_channels: int = struct.static_field()
    branches: jnp.ndarray = struct.field()  # [M, p] conv order
    scale: jnp.ndarray = struct.field()
    window: jnp.ndarray = struct.field()  # [..., M, p-1]
    raw_tail: jnp.ndarray = struct.field()  # [..., M-1]

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, num_channels: int, h, batch_shape: tuple = ()) -> "Firpfbch":
        if num_channels < 2:
            raise ConfigError("number of channels must be at least 2")
        M = num_channels
        branches = pfb_decompose(np.asarray(h), M)  # [M, p], branches[b,p]=h[b+pM]
        p = branches.shape[1]
        return cls(
            num_channels=M,
            branches=jnp.asarray(branches.astype(np.float32)),
            scale=jnp.asarray(1.0, dtype=jnp.float32),
            window=jnp.zeros(batch_shape + (M, p - 1), dtype=jnp.complex64),
            raw_tail=jnp.zeros(batch_shape + (M - 1,), dtype=jnp.complex64),
        )

    @classmethod
    def create_kaiser(cls, num_channels: int, m: int = 4, as_: float = 60.0, **kw) -> "Firpfbch":
        """Kaiser prototype at fc = 0.5/M (liquid firpfbch kaiser ctor)."""
        if m < 1:
            raise ConfigError("filter semi-length must be at least 1")
        return cls.create(num_channels, _design_prototype(num_channels, m, as_), **kw)

    @classmethod
    def create_rnyquist(cls, ftype, num_channels: int, m: int, beta: float, **kw) -> "Firpfbch":
        """Root-Nyquist prototype (liquid firpfbch rnyquist ctor)."""
        h = design.fir_design_prototype(ftype, num_channels, m, beta, 0.0)
        return cls.create(num_channels, h[: 2 * num_channels * m], **kw)

    # ------------------------------------------------------------ properties
    @property
    def p(self) -> int:
        return self.branches.shape[1]

    def get_delay(self) -> int:
        """Group delay in output steps ≈ p/2."""
        return self.p // 2

    def reset(self) -> "Firpfbch":
        return self.replace(
            window=jnp.zeros_like(self.window),
            raw_tail=jnp.zeros_like(self.raw_tail),
        )

    def set_scale(self, scale) -> "Firpfbch":
        return self.replace(scale=jnp.asarray(scale, dtype=jnp.float32))

    # ------------------------------------------------------------- analysis
    def analyzer_execute(self, x) -> tuple[jnp.ndarray, "Firpfbch"]:
        """x [..., N·M] → channels [..., M, N]; channel k centered at +k/M."""
        x = jnp.asarray(x, dtype=jnp.complex64)
        total = x.shape[-1]
        M = self.num_channels
        if total % M:
            raise ConfigError(f"input length must be a multiple of M={M}")
        n = total // M

        # branch streams s_b[i] = x[iM - b] WITHOUT a gather: prepend one
        # history block, reshape to M-sample blocks, reverse each block,
        # shift one block. xfull block i, column c = x[(i-1)M + c], so
        # reversed columns give
        # xrev[i, j] = x[iM - 1 - j] ⇒ s_b[i] = xrev[i, b-1] (b ≥ 1) and
        # s_0[i] = x[iM] = block i+1, column 0.
        lead = x.shape[:-1] + (1,)
        xfull = jnp.concatenate(
            [jnp.zeros(lead, x.dtype), self.raw_tail, x], axis=-1
        )
        xf = xfull.reshape(x.shape[:-1] + (n + 1, M))
        xrev = xf[..., ::-1]
        s0 = xf[..., 1:, 0:1]  # [..., n, 1]
        s_rest = xrev[..., :n, : M - 1]  # [..., n, M-1]
        s = jnp.swapaxes(jnp.concatenate([s0, s_rest], axis=-1), -1, -2)
        xa = jnp.concatenate([self.raw_tail, x], axis=-1)  # (state tail below)

        xb = jnp.concatenate([self.window, s], axis=-1)
        u = _grouped_branch_conv(xb, self.branches)  # [..., M, n]
        y = _idft(u, -2) * (M * self.scale)

        new = self.replace(
            window=xb[..., xb.shape[-1] - (self.p - 1) :] if self.p > 1 else self.window,
            raw_tail=xa[..., xa.shape[-1] - (M - 1) :],
        )
        return y, new

    # ------------------------------------------------------------ synthesis
    def synthesizer_execute(self, ych) -> tuple[jnp.ndarray, "Firpfbch"]:
        """channels [..., M, N] → x [..., N·M] (dual)."""
        ych = jnp.asarray(ych, dtype=jnp.complex64)
        M = self.num_channels
        n = ych.shape[-1]
        w = _idft(ych, -2) * M  # unnormalized IDFT over k
        xb = jnp.concatenate([self.window, w], axis=-1)
        v = _grouped_branch_conv(xb, self.branches)  # [..., M, n]
        x = jnp.swapaxes(v, -1, -2).reshape(ych.shape[:-2] + (n * M,))
        x = x * self.scale
        new = self.replace(
            window=xb[..., xb.shape[-1] - (self.p - 1) :] if self.p > 1 else self.window,
        )
        return x, new


@struct.pytree
class Firpfbch2:
    """Oversampled analysis bank: M channels, M/2 input samples per step
    (liquid firpfbch2, n = 8..64 per LIQUID_COMPAT.md:1765-1798).

    Implemented as the critically-sampled transform evaluated twice per M
    samples: output step t consumes M/2 new samples; the commutator phase
    alternates, equivalent to evaluating the analysis filter at half-frame
    offsets with a (-1)^{kt} post-twiddle on odd steps.
    """

    num_channels: int = struct.static_field()
    branches: jnp.ndarray = struct.field()  # [M, p]
    scale: jnp.ndarray = struct.field()
    hist: jnp.ndarray = struct.field()  # [..., L-1] raw sample history
    step_parity: jnp.ndarray = struct.field()  # int32 (0/1)

    @classmethod
    def create(cls, num_channels: int, m: int = 4, as_: float = 60.0, batch_shape: tuple = ()) -> "Firpfbch2":
        if num_channels < 2 or num_channels % 2:
            raise ConfigError("number of channels must be even and at least 2")
        M = num_channels
        h = _design_prototype(M, m, as_)
        branches = pfb_decompose(h, M)
        L = branches.shape[1] * M  # full prototype span
        return cls(
            num_channels=M,
            branches=jnp.asarray(branches.astype(np.float32)),
            scale=jnp.asarray(1.0, dtype=jnp.float32),
            hist=jnp.zeros(batch_shape + (L - 1,), dtype=jnp.complex64),
            step_parity=jnp.asarray(0, dtype=jnp.int32),
        )

    @property
    def p(self) -> int:
        return self.branches.shape[1]

    def reset(self) -> "Firpfbch2":
        return self.replace(
            hist=jnp.zeros_like(self.hist),
            step_parity=jnp.zeros_like(self.step_parity),
        )

    def analyzer_execute(self, x) -> tuple[jnp.ndarray, "Firpfbch2"]:
        """x [..., T·M/2] → channels [..., M, T] (2× oversampled outputs).

        Output step t uses the window ending at sample (t+1)·M/2:
          y_k[t] = Σ_j h[j]·x[t·M/2 - j + M/2 - ...]·e^{+j2πkj/M}, evaluated
        directly as a full-prototype sliding transform (exact definition of
        an M/2-decimated DFT filter bank).
        """
        x = jnp.asarray(x, dtype=jnp.complex64)
        M = self.num_channels
        half = M // 2
        total = x.shape[-1]
        if total % half:
            raise ConfigError(f"input length must be a multiple of M/2={half}")
        T = total // half
        L = self.p * M

        xa = jnp.concatenate([self.hist, x], axis=-1)  # [..., L-1+T·half]
        t_idx = jnp.arange(T)
        par = self.step_parity
        e_glob = (t_idx + 1) * half - 1 + par * half

        # y_k[t] = Σ_j h[j]·x[e_t - j]·e^{-j2πk(e_t - j)/M}   (mix-down by k/M)
        #        = e^{-j2πk e_t/M} Σ_j h[j]·frame[t,j]·e^{+j2πkj/M}
        # inner sum over j groups by residue r = j mod M:
        #   Σ_r e^{+j2πkr/M} c_r[t],  c_r[t] = Σ_p h[r+pM]·frame[t, r+pM],
        # computed gather-free as one strided residue conv
        c = _sliding_residue_conv(xa, self.branches, half)  # [..., T, M]
        Y = jnp.fft.ifft(c, axis=-1) * M  # Σ_r c_r e^{+j2πkr/M}
        twiddle = jnp.exp(
            -2j * np.pi * jnp.arange(M)[None, :] * e_glob[:, None] / M
        ).astype(jnp.complex64)
        y = (Y * twiddle) * self.scale
        y = jnp.swapaxes(y, -1, -2)  # [..., M, T]

        new = self.replace(
            hist=xa[..., xa.shape[-1] - (L - 1) :],
            step_parity=jnp.mod(par + T, 2),
        )
        return y, new
