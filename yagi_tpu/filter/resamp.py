"""Arbitrary-rate polyphase resampler.

Behavioral spec: /root/reference/src/filter/resampler/resamp.rs. The
reference advances a 32-bit fixed-point phase accumulator per input sample
(step = round(2^24 / r), resamp.rs:103) and emits one output per phase slot
through a selected PFB branch (resamp.rs:141-154) — a data-dependent,
per-sample loop.

Block-parallel formulation (bit-exact):
for global output index m, the accumulated phase is P_m = phase0 + m·step
(64-bit). Output m is emitted while consuming input sample
n_m = P_m >> 24, through branch (P_m & 0xffffff) >> (24-bits). This is an
exact unrolling of the reference's while-loop: emission m happens when the
running phase (which has had n_m wrap-subtractions of 2^24) is
P_m - n_m·2^24 ≤ 0xffffff. The 64-bit products are computed with uint32
pair arithmetic (JAX default has no int64), so results match the reference's
u32 semantics exactly. Outputs are then a branch-row gather + frame gather +
one batched contraction.

Because the output count depends on carried phase, execute_block returns a
fixed-capacity buffer plus the exact count (the jit-friendly strategy from
SURVEY.md §7 "hard parts" #2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from .. import design
from ..math.special import nextpow2
from .firpfb import pfb_decompose

__all__ = ["Resamp"]


def _pq_of_step(step: int) -> tuple | None:
    """(P, Q) of the exactly-periodic u32 schedule, or None (see
    _sched.u32_static_schedule)."""
    import math

    if step <= 0:
        return None
    g = math.gcd(step, 1 << 24)
    p = (1 << 24) // g
    return (p, step // g) if p <= 256 else None

def _u64_emu_phase(phase0: jnp.ndarray, m: jnp.ndarray, step: jnp.ndarray):
    """(hi, lo) uint32 pair = phase0 + m·step, exact 64-bit.

    m: int32 output indices (< 2^31); step, phase0: uint32.
    """
    m = m.astype(jnp.uint32)
    m0 = m & 0xFFFF
    m1 = m >> 16
    s0 = step & 0xFFFF
    s1 = step >> 16
    p00 = m0 * s0
    p01 = m0 * s1
    p10 = m1 * s0
    p11 = m1 * s1
    lo = p00 + ((p01 & 0xFFFF) << 16)
    c1 = (lo < p00).astype(jnp.uint32)
    lo2 = lo + ((p10 & 0xFFFF) << 16)
    c2 = (lo2 < lo).astype(jnp.uint32)
    lo3 = lo2 + phase0
    c3 = (lo3 < lo2).astype(jnp.uint32)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + c1 + c2 + c3
    return hi, lo3


@struct.pytree
class Resamp:
    """Arbitrary resampler state (resamp.rs:8-16)."""

    m: int = struct.static_field()  # filter semi-length (delay)
    bits: int = struct.static_field()  # log2(npfb)
    nominal_rate: float = struct.static_field()  # create-time rate, sizes buffers
    branches: jnp.ndarray = struct.field()  # [npfb, Lsub] convolution order
    rate: jnp.ndarray = struct.field()  # float32 current rate
    step: jnp.ndarray = struct.field()  # uint32 = round(2^24 / rate)
    phase: jnp.ndarray = struct.field()  # uint32 accumulator
    window: jnp.ndarray = struct.field()  # [..., Lsub] PFB window
    # (P, Q) when the u32 schedule is exactly periodic (P | 2^24) AND the
    # carried phase is provably 0 at every block boundary so far — the
    # static-schedule banded-matmul fast path applies (filter/_sched.py).
    # Cleared (None) by any operation that can leave a nonzero phase or a
    # runtime-traced rate; phase ≡ 0 is then re-established only by reset().
    exact_sched: tuple | None = struct.static_field(default=None)
    # prototype cutoff (create-time fc; sizes the farrow design band)
    fc: float = struct.static_field(default=0.25)
    # interpolation mode: "pfb" = reference-parity 256-branch evaluation
    # (banded fast path when exact_sched holds, else the u32 frame gather);
    # "farrow" = gather-free fast path — prototype-FIR + designed polynomial
    # interpolator at the exact u32 times (filter/_farrow_resamp.py;
    # schedule/counts/state bit-identical, values within the reference's
    # own 1/256 branch-quantization floor)
    interp: str = struct.static_field(default="pfb")
    # concrete value of the (traced) u32 step field when provable: set at
    # create()/concrete set_rate(), cleared by traced rate updates. The
    # farrow path's static grid is derived from this certificate.
    step_cert: int | None = struct.static_field(default=None)

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(
        cls,
        rate: float,
        m: int = 7,
        fc: float = 0.25,
        as_: float = 60.0,
        npfb: int = 256,
        batch_shape: tuple = (),
        dtype=jnp.complex64,
        interp: str = "pfb",
    ) -> "Resamp":
        """Design the PFB prototype and initialize state (resamp.rs:24-71).

        ``interp="farrow"`` selects the gather-free fast path for
        truly-arbitrary rates (see the ``interp`` field comment).
        """
        if interp not in ("pfb", "farrow"):
            raise ConfigError("interp must be 'pfb' or 'farrow'")
        if rate <= 0.0:
            raise ConfigError("resampling rate must be greater than zero")
        if m == 0:
            raise ConfigError("filter semi-length must be greater than zero")
        if fc <= 0.0 or fc >= 0.5:
            raise ConfigError("filter cutoff must be in (0,0.5)")
        if as_ <= 0.0:
            raise ConfigError("filter stop-band suppression must be greater than zero")
        bits = nextpow2(npfb)
        if bits < 1 or bits > 16:
            raise ConfigError("number of filter banks must be in (2^0,2^16)")
        npfb = 1 << bits

        n = 2 * m * npfb + 1
        hf = design.fir_design_kaiser(n, fc / npfb, as_, 0.0)
        gain = npfb / np.sum(hf)
        h = (hf * gain).astype(np.float32)
        # the reference constructs the PFB with h_len = n-1 (drops last tap)
        branches = pfb_decompose(h[: n - 1], npfb)

        obj = cls(
            m=m,
            bits=bits,
            nominal_rate=float(rate),
            branches=jnp.asarray(branches),
            rate=jnp.asarray(rate, dtype=jnp.float32),
            step=jnp.asarray(np.uint32(np.round((1 << 24) / rate))),
            phase=jnp.asarray(0, dtype=jnp.uint32),
            window=jnp.zeros(batch_shape + (branches.shape[1],), dtype=jnp.dtype(dtype)),
            exact_sched=_pq_of_step(int(np.round((1 << 24) / rate))),
            fc=float(fc),
            interp=interp,
            step_cert=int(np.round((1 << 24) / rate)),
        )
        return obj._check_rate(rate)

    @classmethod
    def create_default(cls, rate: float, **kw) -> "Resamp":
        """Default parameters (resamp.rs:73-84)."""
        return cls.create(rate, m=7, fc=0.25, as_=60.0, npfb=256, **kw)

    def _check_rate(self, rate: float) -> "Resamp":
        if rate <= 0.0:
            raise ConfigError("resampling rate must be greater than zero")
        if rate < 0.004 or rate > 250.0:
            raise ConfigError("resampling rate must be in [0.004,250]")
        return self

    # ------------------------------------------------------------- properties
    @property
    def npfb(self) -> int:
        return self.branches.shape[0]

    @property
    def sub_len(self) -> int:
        return self.branches.shape[1]

    def get_delay(self) -> int:
        return self.m

    def get_rate(self):
        return self.rate

    # ---------------------------------------------------------------- control
    def reset(self) -> "Resamp":
        # phase returns to 0, so the static-schedule certificate can be
        # re-established — but only when the current step is concrete and
        # still equals the create-time nominal step (field comment above).
        sched = self.exact_sched
        cert = self.step_cert
        if sched is None and not isinstance(self.step, jax.core.Tracer):
            nominal_step = int(np.round((1 << 24) / self.nominal_rate))
            if int(np.asarray(self.step)) == nominal_step:
                sched = _pq_of_step(nominal_step)
                # the same concrete-step check re-certifies the farrow fast
                # path (a reset after a traced set_rate must not leave it
                # silently disabled)
                cert = nominal_step
        return self.replace(
            phase=jnp.zeros_like(self.phase),
            window=jnp.zeros_like(self.window),
            exact_sched=sched,
            step_cert=cert,
        )

    def set_rate(self, rate) -> "Resamp":
        """Update rate; step = round(2^24 / r) (resamp.rs:95-106).

        Accepts traced values (for timing loops); range-checks only concrete
        Python floats.
        """
        cert = None
        if isinstance(rate, (int, float)):
            self._check_rate(float(rate))
            cert = int(np.round((1 << 24) / float(rate)))
        r = jnp.asarray(rate, dtype=jnp.float32)
        if cert is not None:
            # concrete rate: same f64 rounding as create() (the f32 division
            # below can differ by 1 ulp, silently desyncing step from cert)
            step = jnp.asarray(np.uint32(cert))
        else:
            step = jnp.round((1 << 24) / r).astype(jnp.uint32)
        # a rate change at a (possibly) nonzero carried phase invalidates the
        # phase≡0 invariant of the static-schedule fast path
        return self.replace(rate=r, step=step, exact_sched=None, step_cert=cert)

    def adjust_rate(self, gamma) -> "Resamp":
        """Multiplicative rate adjustment (resamp.rs:112)."""
        return self.set_rate(self.rate * jnp.asarray(gamma, dtype=jnp.float32))

    # ------------------------------------------------------------- num output
    def get_num_output(self, num_input: int) -> int:
        """Exact output count for the next num_input samples (resamp.rs:128).

        Host-side exact integer replay; requires concrete (non-traced) state.
        """
        phase = int(np.asarray(self.phase))
        step = int(np.asarray(self.step))
        total = phase + 0  # python ints are arbitrary precision
        end = num_input << 24
        if total > end - 1:
            return 0
        return (end - 1 - total) // step + 1

    def out_capacity(self, num_input: int, rate_hint: float | None = None) -> int:
        """Static output-buffer capacity for a block of num_input samples.

        Sized from the create-time nominal rate (static under jit); pass
        ``rate_hint`` if the rate has been adjusted upward at runtime.
        """
        r = self.nominal_rate if rate_hint is None else rate_hint
        # round up to a multiple of 8: a downstream feedback scan over this
        # buffer then divides evenly by its unroll, and the +margin is free
        # capacity anyway
        return -(-(int(np.ceil(num_input * r)) + 4) // 8) * 8

    def _static_fast(self, xa, n: int, out_capacity: int):
        """Static-schedule banded-matmul resample, or None if inapplicable.

        Valid only while ``exact_sched`` certifies the u32 phase is 0 at
        every block boundary (see the field's comment). Returns
        ``(y, n_out)`` with ``y`` zero-padded to ``out_capacity``; identical
        (src, branch) schedule to the u32 path, evaluated as one banded
        matmul (filter/_sched.py) instead of a dynamic frame gather.
        """
        if self.exact_sched is None:
            return None
        p_s, q_s = self.exact_sched
        n_out = (n // q_s) * p_s
        if n % q_s != 0 or n_out > out_capacity:
            return None
        from ._sched import (sched_banded_matmul, sched_matmul_ok,
                             u32_static_schedule)

        if not sched_matmul_ok(p_s, q_s, self.sub_len):
            return None
        sched = u32_static_schedule(
            int(np.round((1 << 24) / self.nominal_rate)), self.bits, self.npfb
        )
        if sched is None:
            return None
        _, _, src_off, br_idx = sched
        y = sched_banded_matmul(xa, self.branches, src_off, br_idx, q_s,
                                n // q_s)
        pad = out_capacity - n_out
        if pad:
            y = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, pad)])
        return y, n_out

    # ------------------------------------------------------------- streaming
    def execute_block(
        self, x, out_capacity: int | None = None
    ) -> tuple[jnp.ndarray, jnp.ndarray, "Resamp"]:
        """Resample a block (resamp.rs:156-165).

        Returns (y, num_output, state): y has static length ``out_capacity``
        with valid samples in y[..., :num_output] and zeros beyond.
        """
        x = jnp.asarray(x)
        n = x.shape[-1]
        if out_capacity is None:
            out_capacity = self.out_capacity(n)

        L = self.sub_len
        xa = jnp.concatenate([self.window[..., 1:].astype(x.dtype), x], axis=-1)

        # --- static-schedule fast path (phase provably ≡ 0) ----------------
        fast = self._static_fast(xa, n, out_capacity)
        if fast is not None:
            y, n_out = fast
            return (
                y,
                jnp.asarray(n_out, jnp.int32),
                self.replace(window=xa[..., xa.shape[-1] - L:]),
            )
        # (misaligned blocks fall through to the u32 path below, which
        # clears exact_sched via ``keep``)

        # --- emission schedule (pure integer math, exact) -----------------
        # one extra index so lo[num_output] is always in range (phase carry)
        m_idx = jnp.arange(out_capacity + 1, dtype=jnp.int32)
        hi, lo = _u64_emu_phase(self.phase, m_idx, self.step)
        hi, lo_full = hi[:out_capacity], lo
        lo = lo_full[:out_capacity]
        n_m = ((hi << 8) | (lo >> 24)).astype(jnp.int32)  # source sample index
        # branch = ((lo & 0xffffff) >> (24-bits)), written shift-then-AND
        branch = ((lo >> (24 - self.bits)) & jnp.uint32(self.npfb - 1)).astype(
            jnp.int32
        )
        valid = n_m < n
        num_output = jnp.sum(valid.astype(jnp.int32), axis=-1)

        if self.interp == "farrow" and self.step_cert is not None:
            # --- fast path: prototype FIR + designed Farrow --------------
            # exact u32 schedule above is untouched (counts/state/phase
            # bit-identical); values within the reference's own 1/256
            # branch-quantization floor (filter/_farrow_resamp.py)
            from ._farrow_resamp import farrow_resample_values

            y = farrow_resample_values(
                xa, self.branches, self.phase, self.step_cert, n,
                out_capacity, n_m, branch, lo, valid,
                band=round(min(0.42, 1.4 * self.fc), 3),
            )
        else:
            # --- gather frames + branch rows, contract (reference path) --
            starts = jnp.clip(n_m, 0, n - 1)  # frame m = xa[s : s+L]
            frame_idx = starts[:, None] + jnp.arange(L)[None, :]
            frames = xa[..., frame_idx]  # [..., cap, L] oldest..newest
            hb = jnp.take(self.branches, branch, axis=0)  # [cap, L]
            # y_m = Σ_j hb[m, j] · frames[m, L-1-j]
            y = jnp.einsum(
                "...cl,cl->...c",
                frames,
                hb[:, ::-1],
                precision=jax.lax.Precision.HIGHEST,
            )
            y = jnp.where(valid, y, 0)

        # --- carry state ---------------------------------------------------
        # phase' = (phase + num_output·step) - n·2^24 (mod 2^32, exact,
        # resamp.rs:149-151). phase + num_output·step mod 2^32 is exactly
        # lo_full[num_output].
        new_phase = lo_full[num_output] - jnp.uint32((n & 0xFF) << 24)
        new_window = xa[..., xa.shape[-1] - L :]
        keep = (
            self.exact_sched is not None
            and n % self.exact_sched[1] == 0
            and (n // self.exact_sched[1]) * self.exact_sched[0] <= out_capacity
        )
        return y, num_output, self.replace(
            phase=new_phase, window=new_window,
            exact_sched=self.exact_sched if keep else None,
        )

    __call__ = execute_block

    def execute_block_n(
        self, x, n_valid, out_capacity: int | None = None
    ) -> tuple[jnp.ndarray, jnp.ndarray, "Resamp"]:
        """Valid-prefix variant of :meth:`execute_block` (jit-friendly
        variable-rate pipelines): only the first ``n_valid`` samples of the
        fixed-capacity buffer ``x`` are consumed. The u32 phase advances by
        exactly the emissions a sequential run over those samples would make
        (resamp.rs:141-154), and the PFB window lands at the traced valid
        end via a dynamic slice."""
        x = jnp.asarray(x)
        cap = x.shape[-1]
        n_valid = jnp.asarray(n_valid, dtype=jnp.int32)
        if out_capacity is None:
            out_capacity = self.out_capacity(cap)

        L = self.sub_len
        x = jnp.where(jnp.arange(cap) < n_valid, x, 0)
        xa = jnp.concatenate([self.window[..., 1:].astype(x.dtype), x], axis=-1)

        m_idx = jnp.arange(out_capacity + 1, dtype=jnp.int32)
        hi, lo = _u64_emu_phase(self.phase, m_idx, self.step)
        hi, lo_full = hi[:out_capacity], lo
        lo = lo_full[:out_capacity]
        n_m = ((hi << 8) | (lo >> 24)).astype(jnp.int32)
        branch = ((lo >> (24 - self.bits)) & jnp.uint32(self.npfb - 1)).astype(
            jnp.int32
        )
        valid = n_m < n_valid
        num_output = jnp.sum(valid.astype(jnp.int32), axis=-1)

        starts = jnp.clip(n_m, 0, cap - 1)
        frame_idx = starts[:, None] + jnp.arange(L)[None, :]
        frames = xa[..., frame_idx]
        hb = jnp.take(self.branches, branch, axis=0)
        y = jnp.einsum(
            "...cl,cl->...c",
            frames,
            hb[:, ::-1],
            precision=jax.lax.Precision.HIGHEST,
        )
        y = jnp.where(valid, y, 0)

        nv_u = n_valid.astype(jnp.uint32)
        new_phase = lo_full[num_output] - ((nv_u & jnp.uint32(0xFF)) << 24)
        sliced = jax.lax.dynamic_slice_in_dim(
            xa, jnp.maximum(n_valid - 1, 0), L, axis=-1
        )
        new_window = jnp.where(n_valid > 0, sliced, self.window)
        # traced consumption count → phase≡0 invariant no longer provable
        return y, num_output, self.replace(
            phase=new_phase, window=new_window, exact_sched=None
        )

    def execute_block_mix_down(
        self, x, osc, out_capacity: int | None = None
    ):
        """Resample then NCO down-mix in ONE fused consumer chain.

        Semantically identical to ``execute_block`` followed by
        ``osc.mix_block_down_n`` (same integer schedule, same u32 phase ramp,
        same sin/cos path), but the rotation is applied directly to the
        polyphase dot-product output so XLA keeps resample+mix in a single
        fusion instead of a second pass over the 2×-rate stream in device
        memory.

        Returns ``(y_mixed, num_output, new_resamp, new_osc)``.
        """
        from ..nco.osc import _sin_cos, jax_complex

        x = jnp.asarray(x)
        n = x.shape[-1]
        if out_capacity is None:
            out_capacity = self.out_capacity(n)

        L = self.sub_len
        xa = jnp.concatenate([self.window[..., 1:].astype(x.dtype), x], axis=-1)
        fast = self._static_fast(xa, n, out_capacity)
        if fast is not None:
            yf, n_out = fast
            thetas = osc.theta[..., None] + jnp.arange(
                out_capacity, dtype=jnp.uint32
            ) * osc.d_theta[..., None]
            s, c = _sin_cos(thetas, osc.mode)
            m_valid = jnp.arange(out_capacity) < n_out
            yf = jnp.where(m_valid, yf * jax_complex(c, -s), 0)
            new_osc = osc.replace(
                theta=osc.theta + jnp.uint32(n_out) * osc.d_theta
            )
            return (
                yf,
                jnp.asarray(n_out, jnp.int32),
                self.replace(window=xa[..., xa.shape[-1] - L:]),
                new_osc,
            )
        m_idx = jnp.arange(out_capacity + 1, dtype=jnp.int32)
        hi, lo = _u64_emu_phase(self.phase, m_idx, self.step)
        hi, lo_full = hi[:out_capacity], lo
        lo = lo_full[:out_capacity]
        n_m = ((hi << 8) | (lo >> 24)).astype(jnp.int32)
        branch = ((lo >> (24 - self.bits)) & jnp.uint32(self.npfb - 1)).astype(
            jnp.int32
        )
        valid = n_m < n
        num_output = jnp.sum(valid.astype(jnp.int32), axis=-1)

        starts = jnp.clip(n_m, 0, n - 1)
        frame_idx = starts[:, None] + jnp.arange(L)[None, :]
        frames = xa[..., frame_idx]
        hb = jnp.take(self.branches, branch, axis=0)
        y = jnp.einsum(
            "...cl,cl->...c",
            frames,
            hb[:, ::-1],
            precision=jax.lax.Precision.HIGHEST,
        )
        # same ramp/sin-cos as Osc._phase_ramp + mix_block_down_n → the mixed
        # output is bit-identical to the unfused two-step path
        thetas = osc.theta[..., None] + jnp.arange(
            out_capacity, dtype=jnp.uint32
        ) * osc.d_theta[..., None]
        s, c = _sin_cos(thetas, osc.mode)
        y = jnp.where(valid, y * jax_complex(c, -s), 0)

        new_phase = lo_full[num_output] - jnp.uint32((n & 0xFF) << 24)
        new_window = xa[..., xa.shape[-1] - L :]
        new_osc = osc.replace(
            theta=osc.theta + num_output.astype(jnp.uint32) * osc.d_theta
        )
        return (
            y,
            num_output,
            self.replace(
                phase=new_phase, window=new_window,
                # keep the phase≡0 invariant only when this block provably
                # consumed whole schedule periods within capacity
                exact_sched=self.exact_sched
                if (self.exact_sched is not None
                    and n % self.exact_sched[1] == 0
                    and (n // self.exact_sched[1]) * self.exact_sched[0]
                    <= out_capacity)
                else None,
            ),
            new_osc,
        )

    def execute(self, x_one):
        """Single-sample API parity (resamp.rs:141)."""
        y, k, q = self.execute_block(jnp.asarray(x_one)[..., None])
        return y, k, q
