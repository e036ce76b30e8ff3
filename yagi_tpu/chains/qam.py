"""QAM receiver / symbol tracker chain.

Fills the reference's 0-byte framing stub (src/framing/symtrack.rs) and
packages BASELINE config[3] ("16-QAM rx with EVM"). Follows liquid's
symtrack_cccf composition: AGC → polyphase symbol synchronizer (2
samples/symbol out) → decision-directed LMS equalizer → carrier-phase PLL →
hard-decision demod, with running EVM.

The whole pipeline is one pytree with a jittable ``step``: the symsync emits
a fixed-capacity, front-compacted buffer with a valid count, and the
eq/carrier stage scans that capacity gating every state update on validity —
so the chain is block-split invariant and shape-static under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..agc import Agc
from ..design import FirFilterShape
from ..equalization import Eqlms
from ..errors import ConfigError
from ..filter import Symsync
from ..kernels import use_kernel
from ..kernels.symscan import supported
from ..modem import Modem

__all__ = ["QamRx"]


def _tree_where(pred, a, b):
    """Per-leaf select with trailing-dim broadcast of a batch-shaped pred."""

    def sel(x, y):
        nd = getattr(x, "ndim", 0)
        shape = getattr(x, "shape", ())
        if nd < pred.ndim or shape[: pred.ndim] != pred.shape:
            # leaf carries no batch dims (shared constant, e.g. the
            # equalizer's h0 reference taps): identical in both branches,
            # so per-batch selection is a no-op
            return x
        p = pred.reshape(pred.shape + (1,) * (nd - pred.ndim))
        return jnp.where(p, x, y)

    return jax.tree_util.tree_map(sel, a, b)


@struct.pytree
class QamRx:
    """agc → symsync → eqlms → carrier PLL → demod (symtrack semantics)."""

    k: int = struct.static_field()  # input samples/symbol
    k_eq: int = struct.static_field()  # samples/symbol into the equalizer (2)
    agc: Agc = struct.field()
    symsync: Symsync = struct.field()
    eq: Eqlms = struct.field()
    table: jnp.ndarray = struct.field()  # constellation points
    alpha: jnp.ndarray = struct.field()  # PLL proportional gain
    beta: jnp.ndarray = struct.field()  # PLL integral gain
    theta: jnp.ndarray = struct.field()  # carrier phase
    dtheta: jnp.ndarray = struct.field()  # carrier frequency
    sym_phase: jnp.ndarray = struct.field()  # int32 mod k_eq
    evm_accum: jnp.ndarray = struct.field()
    evm_count: jnp.ndarray = struct.field()
    # symsync outputs beyond the equalizer-scan capacity ever dropped
    # (should stay 0; nonzero flags a sustained timing-rate transient
    # exceeding the 25% headroom — see step())
    overflow_count: jnp.ndarray = struct.field()
    # emission slots per input step in the fused scan (each slot carries a
    # full eq/carrier update). 2 covers acquisition transients exactly;
    # slots=1 halves the scan body but measurably defers during
    # acquisition (overflow_count ≫ 0) — keep 2 unless the stream is known
    # pre-locked
    slots: int = struct.static_field(default=2)

    @classmethod
    def create(
        cls,
        ftype: str = "rrcos",
        k: int = 2,
        m: int = 7,
        beta: float = 0.3,
        scheme: str = "qam16",
        eq_len: int = 7,
        eq_bw: float = 0.02,
        pll_bw: float = 0.02,
        batch_shape: tuple = (),
        slots: int = 2,
    ) -> "QamRx":
        if k < 2:
            raise ConfigError("samples/symbol must be at least 2")
        if not 0.0 < beta <= 1.0:
            raise ConfigError("filter excess bandwidth must be in (0, 1]")
        if eq_len % 2 == 0:
            raise ConfigError("equalizer length must be odd")
        modem = Modem.create(scheme)
        if isinstance(ftype, str):
            ftype = FirFilterShape.from_str(ftype)
        ss = Symsync.create_rnyquist(
            ftype, k, m, beta, batch_shape=batch_shape
        ).set_output_rate(2)
        # identity init: the symsync already matched-filters, so the eq
        # starts as a pure (eq_len-1)/2-sample delay and learns residual ISI
        eq = Eqlms.create(h_len=eq_len, batch_shape=batch_shape).set_bw(eq_bw)
        z = jnp.zeros(batch_shape, dtype=jnp.float32)
        return cls(
            k=k,
            k_eq=2,
            # narrow AGC: wide loops track the QAM envelope itself and
            # distort the constellation (~12 dB EVM penalty at bw=0.02)
            agc=Agc.create(batch_shape=batch_shape).set_bandwidth(1e-3),
            symsync=ss,
            eq=eq,
            table=modem.table,
            alpha=jnp.asarray(pll_bw, dtype=jnp.float32),
            beta=jnp.asarray(0.5 * pll_bw * pll_bw, dtype=jnp.float32),
            theta=z,
            dtheta=z,
            # the eq's initial lowpass delays by (eq_len-1)/2 samples; start
            # the symbol-phase counter so instants line up at the eq OUTPUT
            sym_phase=jnp.full(batch_shape, (-((eq_len - 1) // 2)) % 2, jnp.int32),
            evm_accum=z,
            evm_count=z,
            overflow_count=jnp.zeros(batch_shape, dtype=jnp.int32),
            slots=slots,
        )

    def reset(self) -> "QamRx":
        z = jnp.zeros_like(self.theta)
        return self.replace(
            agc=self.agc.reset(),
            symsync=self.symsync.reset(),
            eq=self.eq.reset(),
            theta=z,
            dtheta=z,
            sym_phase=jnp.full_like(
                self.sym_phase, (-((self.eq.h_len - 1) // 2)) % 2
            ),
            evm_accum=z,
            evm_count=z,
            overflow_count=jnp.zeros_like(self.overflow_count),
        )

    def set_bandwidth(self, pll_bw: float) -> "QamRx":
        """Carrier-loop bandwidth (symtrack set_bandwidth semantics)."""
        if isinstance(pll_bw, (int, float)) and pll_bw < 0.0:
            raise ConfigError("bandwidth must be non-negative")
        bw = jnp.asarray(pll_bw, dtype=jnp.float32)
        return self.replace(alpha=bw, beta=0.5 * bw * bw)

    def get_evm(self):
        """Running EVM in dB over all demodulated symbols."""
        ms = self.evm_accum / jnp.maximum(self.evm_count, 1.0)
        return 10.0 * jnp.log10(jnp.maximum(ms, 1e-12))

    def _eq_machinery(self):
        """Shared eq/carrier slot closure + initial carry for the fused and
        decoupled scan formulations (identical math either way)."""
        from ..utils.planar import loop_constants

        nbat = self.theta.ndim
        h_len = self.eq.h_len
        M = self.table.shape[0]
        alpha_v, beta_v = loop_constants(self.alpha, self.beta, like=self.theta)
        tshape = (M,) + (1,) * nbat
        table_r, table_i = jax.lax.optimization_barrier(
            (jnp.real(self.table).reshape(tshape),
             jnp.imag(self.table).reshape(tshape))
        )
        midx = jnp.arange(M, dtype=jnp.uint32).reshape(tshape)

        def eq_slot(carry, xi_r, xi_i, vi):
            """One emission slot through eq + carrier PLL (masked on vi).

            The eq state is carried TRANSPOSED ([h_len, *batch]: taps
            leading, batch minor) and planar, so every in-loop eq op is a
            dense [h_len, *batch] vector op. Math identical to
            Eqlms.push/execute/step (eqlms.rs:125-187).
            """
            (br, bi, x2t, x2s, cnt, wr, wi,
             theta, dtheta, sph, eacc, ecnt) = carry
            # push (eqlms.rs:125): shift taps along the leading axis
            x2n = xi_r * xi_r + xi_i * xi_i
            br_p = jnp.concatenate([br[1:], xi_r[None]], axis=0)
            bi_p = jnp.concatenate([bi[1:], xi_i[None]], axis=0)
            x2_p = jnp.concatenate([x2t[1:], x2n[None]], axis=0)
            x2s_p = x2s + x2n - x2t[0]
            cnt_p = cnt + 1
            # execute (eqlms.rs:137): y = conj(w)-dot-buf
            yr = jnp.sum(wr * br_p + wi * bi_p, axis=0)
            yi = jnp.sum(wr * bi_p - wi * br_p, axis=0)
            is_sym = vi & (sph == 0)
            # gate adaptation on healthy buffer energy: the normalized-LMS
            # step divides by x2_sum, which explodes on the symsync warm-up
            # transient (liquid symtrack gates via acquire states instead)
            can_adapt = is_sym & (x2s_p > 0.5 * h_len)

            # carrier derotation vs = y*exp(-j*theta)
            co, sn = jnp.cos(theta), jnp.sin(theta)
            vs_r = yr * co + yi * sn
            vs_i = yi * co - yr * sn
            d2 = (vs_r[None] - table_r) ** 2 + (vs_i[None] - table_i) ** 2
            s = jnp.argmin(d2, axis=0).astype(jnp.uint32)
            # one-hot constellation select instead of a per-channel gather
            oh = s[None] == midx
            sr = jnp.sum(jnp.where(oh, table_r, 0), axis=0)
            si = jnp.sum(jnp.where(oh, table_i, 0), axis=0)

            pe = (vs_i * sr - vs_r * si) / jnp.maximum(sr * sr + si * si, 1e-12)
            theta_n = theta + dtheta + alpha_v * pe
            dtheta_n = dtheta + beta_v * pe
            # training update (eqlms.rs:170-187) toward d = s_hat*exp(+j*theta):
            # alpha = d - y;  w += mu*conj(alpha)*buf / max(sum|x|^2, eps)
            ar = (sr * co - si * sn) - yr
            ai = (si * co + sr * sn) - yi
            g = self.eq.mu / jnp.maximum(x2s_p, 1e-20)
            wr_u = wr + g[None] * (ar[None] * br_p + ai[None] * bi_p)
            wi_u = wi + g[None] * (ar[None] * bi_p - ai[None] * br_p)

            vi_t = vi[None]
            adapt = can_adapt & (cnt_p >= h_len)  # eqlms.rs ready gate
            ad_t = adapt[None]
            br = jnp.where(vi_t, br_p, br)
            bi = jnp.where(vi_t, bi_p, bi)
            x2t = jnp.where(vi_t, x2_p, x2t)
            x2s = jnp.where(vi, x2s_p, x2s)
            cnt = jnp.where(vi, cnt_p, cnt)
            wr = jnp.where(ad_t, wr_u, wr)
            wi = jnp.where(ad_t, wi_u, wi)
            theta = jnp.where(can_adapt, theta_n, theta)
            dtheta = jnp.where(can_adapt, dtheta_n, dtheta)
            if self.k_eq == 2:  # static: XOR toggle, one op
                sph = jnp.where(vi, sph ^ 1, sph)
            else:
                sph = jnp.where(vi, (sph + 1) % self.k_eq, sph)
            ev = (vs_r - sr) ** 2 + (vs_i - si) ** 2
            eacc = jnp.where(can_adapt, eacc + ev, eacc)
            ecnt = jnp.where(can_adapt, ecnt + 1.0, ecnt)
            # per-slot f32 lanes: [sym, re(vs), im(vs), is_sym]
            lanes = [s.astype(jnp.float32), vs_r, vs_i,
                     is_sym.astype(jnp.float32)]
            carry = (br, bi, x2t, x2s, cnt, wr, wi,
                     theta, dtheta, sph, eacc, ecnt)
            return carry, lanes

        tp = lambda v: jnp.moveaxis(v, -1, 0)  # noqa: E731
        eq_carry0 = (
            tp(jnp.real(self.eq.buffer)), tp(jnp.imag(self.eq.buffer)),
            tp(self.eq.x2), self.eq.x2_sum, self.eq.count,
            tp(jnp.real(self.eq.w)), tp(jnp.imag(self.eq.w)),
            self.theta, self.dtheta, self.sym_phase,
            self.evm_accum, self.evm_count,
        )
        return eq_slot, eq_carry0

    def _finish_from_eq(self, eq_c, agc, ss_new, pv=None, overflow=None):
        """Rebuild the chain pytree from the eq-scan carry."""
        (brf, bif, x2tf, x2sf, cntf, wrf, wif,
         theta, dtheta, sph, eacc, ecnt) = eq_c
        fp = lambda v: jnp.moveaxis(v, 0, -1)  # noqa: E731
        eq = self.eq.replace(
            buffer=jax.lax.complex(fp(brf), fp(bif)),
            x2=fp(x2tf), x2_sum=x2sf, count=cntf,
            w=jax.lax.complex(fp(wrf), fp(wif)),
        )
        return self.replace(
            agc=agc, symsync=ss_new, eq=eq, theta=theta, dtheta=dtheta,
            sym_phase=sph, evm_accum=eacc, evm_count=ecnt,
            overflow_count=(self.overflow_count if overflow is None
                            else self.overflow_count + overflow),
        )

    def _step_masked_decoupled(self, x, backend: str = "triton",
                               interpret: bool = False):
        """symsync kernel → eq-only scan (see step_masked routing note)."""
        n = x.shape[-1]
        E = self.slots
        s_agc = next(s for s in (8, 4, 2, 1) if n % s == 0)
        y0, agc = self.agc.execute_block(x, samples_per_step=s_agc)
        y_slots, v_slots, ss_new = self.symsync.execute_slots(
            y0, max_emit=E, backend=backend, interpret=interpret,
        )  # [C, n, E]
        # time-major planar xs for the eq scan
        yr = jax.lax.optimization_barrier(
            jnp.transpose(jnp.real(y_slots), (1, 2, 0)))  # [n, E, C]
        yi = jax.lax.optimization_barrier(
            jnp.transpose(jnp.imag(y_slots), (1, 2, 0)))
        vfm = jax.lax.optimization_barrier(
            jnp.transpose(v_slots, (1, 2, 0)).astype(jnp.float32))
        eq_slot, eq_carry0 = self._eq_machinery()

        def body(eq_c, inp):
            yr_s, yi_s, vf_s = inp  # each [E, C]
            lanes = []
            for e in range(E):
                eq_c, sl = eq_slot(eq_c, yr_s[e], yi_s[e], vf_s[e] > 0.5)
                lanes += sl
            return eq_c, jnp.stack(lanes, axis=0)  # [4E, C]

        eq_c, packed = jax.lax.scan(body, eq_carry0, (yr, yi, vfm), unroll=2)
        # [n, 4E, C] → [C, n, 4E] → [C, nE, 4]
        packed = jnp.transpose(packed, (2, 0, 1))
        packed = packed.reshape(packed.shape[:-2] + (n * E, 4))
        syms = packed[..., 0].astype(jnp.uint32)
        soft = jax.lax.complex(packed[..., 1], packed[..., 2])
        mask = packed[..., 3] > 0.5
        return syms, soft, mask, self._finish_from_eq(eq_c, agc, ss_new)

    def step_masked(self, x, samples_per_step: int | None = None,
                    backend: str = "auto", interpret: bool = False):
        """Process one block; masked (uncompacted) outputs.

        Returns ``(syms, soft, mask, chain)`` with ``syms``/``soft``/``mask``
        shaped ``[..., 2·N]`` (two symsync emission slots per input step, in
        stream order); entries where ``mask`` is False are padding. This is
        the compaction-free fast path — :meth:`step` wraps it with
        front-compaction for the symtrack-style API.

        Routes (``backend``, as :meth:`Symsync.execute_slots`): on the
        kernel route the symsync loop runs as its Triton kernel and an
        eq-only scan follows (``interpret=True`` runs the kernel in Pallas
        interpret mode). On the XLA route ONE joint lax.scan runs the
        symsync timing loop AND the eq/carrier loop together — the symsync
        emission slots feed the equalizer inside the same step, saving a
        second scan and the [..., 2N] intermediate. The AGC stays a
        separate (packed) scan either way: its gain feedback precedes the
        matched filter, which is what makes the all-branch precompute
        legal.

        The symsync at ``k_out = 2`` emits ≤ 1 symbol-rate sample per input
        in steady state; two slots absorb timing transients. When a third
        emission would be pending within one input step (rate < ½ nominal —
        pathological), it is deferred to the next step by the bounded
        emission unroll and counted in ``chain.overflow_count``.
        """
        from ..filter.symsync import _emit_sample, _sym_carry, _sym_loop_params
        from ..utils.planar import loop_constants

        x = jnp.asarray(x)
        n = x.shape[-1]
        bs = self.theta.shape
        ss0 = self.symsync
        if samples_per_step is None and use_kernel(
            backend, supported(bs, ss0.mf.shape[1])
        ):
            # DECOUPLED formulation: the symsync loop runs as its Triton
            # kernel, then an eq-only scan consumes its emission slots.
            # Math is identical to the joint scan below; slot deferral
            # beyond `slots` is handled by the kernel's bounded unroll
            # (overflow_count not incremented on this path).
            return self._step_masked_decoupled(x, backend, interpret)
        if len(bs) == 1 and 0 < bs[0] < 8:
            # C < 8 channels compiles the fused scan to near-scalar ops
            # (utils/smallbatch.py); run at 8 edge-replicated channels and
            # slice back
            from ..filter.symsync import _BATCH_FIELDS as _SS_F
            from ..utils.smallbatch import pad_fields, take_fields

            C, pad = bs[0], 8 - bs[0]
            agc_f = ("g", "scale", "alpha", "y2_prime", "locked",
                     "squelch_mode", "squelch_threshold", "squelch_timer")
            eq_f = ("w", "buffer", "x2", "x2_sum", "count")
            own_f = ("theta", "dtheta", "sym_phase", "evm_accum",
                     "evm_count", "overflow_count")
            padded = pad_fields(self, own_f, pad).replace(
                agc=pad_fields(self.agc, agc_f, pad),
                symsync=pad_fields(self.symsync, _SS_F, pad),
                eq=pad_fields(self.eq, eq_f, pad),
            )
            xp = jnp.pad(x, [(0, pad), (0, 0)], mode="edge")
            syms, soft, mask, new = padded.step_masked(
                xp, samples_per_step=samples_per_step, backend="xla"
            )
            new = take_fields(new, own_f, C).replace(
                agc=take_fields(new.agc, agc_f, C),
                symsync=take_fields(new.symsync, _SS_F, C),
                eq=take_fields(new.eq, eq_f, C),
            )
            return syms[:C], soft[:C], mask[:C], new
        E = self.slots
        S = 1 if samples_per_step is None else samples_per_step
        # pack the AGC scan (bit-identical for any S — agc.py): its body is
        # a handful of scalar ops, so the per-step fixed cost dominates at
        # S=1 and packing 8 samples/step cuts the scan length 8x
        s_agc = next(s for s in (8, 4, 2, 1) if n % s == 0)
        y0, agc = self.agc.execute_block(x, samples_per_step=s_agc)
        ss = self.symsync
        kf = jnp.float32(ss.k)
        xs4, xa = ss.branch_outputs_4xP(y0)
        # [n, 4, P, ...] → [n/S, S, 4, P, ...]; barrier: in-graph xs
        # otherwise get re-derived inside every loop iteration
        xs4 = jax.lax.optimization_barrier(
            xs4.reshape((n // S, S) + xs4.shape[1:])
        )
        sparams = _sym_loop_params(ss)
        eq_slot, eq_carry0 = self._eq_machinery()

        def body(carry, inp):
            sym_c, eq_c, ovf = carry
            packs = []
            for s in range(S):
                sym_c, slots, pending = _emit_sample(sparams, sym_c, inp[s], E, kf)
                lanes = []
                for (yr, yi, vf) in slots:
                    eq_c, slot_lanes = eq_slot(eq_c, yr, yi, vf > 0.5)
                    lanes += slot_lanes
                # deferred third emission this input step (see docstring)
                ovf = ovf + pending.astype(jnp.int32)
                # SLOT-MAJOR ys [4E, *batch]: batch stays the minor axis of
                # every per-step write
                packs.append(jnp.stack(lanes, axis=0))
            packed = jnp.stack(packs, axis=0) if S > 1 else packs[0]
            return (sym_c, eq_c, ovf), packed

        carry0 = (_sym_carry(ss), eq_carry0,
                  jnp.zeros_like(self.overflow_count))
        # unroll 2 (the loop body is a few dozen small vector ops)
        carry, packed = jax.lax.scan(body, carry0, xs4, unroll=max(1, 2 // S))
        sym_c, eq_c, overflow = carry
        (b, bf, tau, tau_d, rate, delta, dec, pv0, pv1) = sym_c
        pv = jnp.stack([pv0, pv1], axis=-1)
        (brf, bif, x2tf, x2sf, cntf, wrf, wif,
         theta, dtheta, sph, eacc, ecnt) = eq_c
        fp = lambda v: jnp.moveaxis(v, 0, -1)  # noqa: E731
        eq = self.eq.replace(
            buffer=jax.lax.complex(fp(brf), fp(bif)),
            x2=fp(x2tf), x2_sum=x2sf, count=cntf,
            w=jax.lax.complex(fp(wrf), fp(wif)),
        )

        if S > 1:  # [n/S, S, 4E, *batch] → [n, 4E, *batch]
            packed = packed.reshape((n,) + packed.shape[2:])
        # [n, 4E, *batch] → [*batch, n, 4E] → [..., 2N, 4] (one transpose
        # instead of 16x-padded per-step writes)
        packed = jnp.transpose(
            packed, tuple(range(2, packed.ndim)) + (0, 1)
        )
        packed = packed.reshape(packed.shape[:-2] + (n * E, 4))
        syms = packed[..., 0].astype(jnp.uint32)
        soft = jax.lax.complex(packed[..., 1], packed[..., 2])
        mask = packed[..., 3] > 0.5

        ss_new = ss.replace(
            window=xa[..., n:], b=b, bf=bf, tau=tau, tau_decim=tau_d,
            rate=rate, delta=delta, decim_counter=dec, pll_v=pv,
        )
        new = self.replace(
            agc=agc, symsync=ss_new, eq=eq, theta=theta, dtheta=dtheta,
            sym_phase=sph, evm_accum=eacc, evm_count=ecnt,
            overflow_count=self.overflow_count + overflow,
        )
        return syms, soft, mask, new

    def step(self, x):
        """Process one block (symtrack-style compacted API).

        Returns ``(syms, soft, num_syms, chain)``: ``syms`` (uint32) and
        ``soft`` (complex, carrier-corrected equalizer output) have capacity
        ``2·N`` entries compacted to the front; ``num_syms`` counts the
        valid ones. Emissions beyond 2 per input step are deferred and
        counted in ``chain.overflow_count`` (see :meth:`step_masked`).
        """
        from ..utils.compact import compact_valid

        syms, soft, mask, new = self.step_masked(x)
        soft, num_syms = compact_valid(soft, mask)
        syms, _ = compact_valid(syms, mask)
        return syms, soft, num_syms, new

    __call__ = step
