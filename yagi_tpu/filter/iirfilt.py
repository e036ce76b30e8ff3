"""Streaming infinite impulse response filter.

Behavioral spec: /root/reference/src/filter/iir/iirfilt.rs. Two realizations:
transfer-function form (direct form II via the v-buffer recurrence,
iirfilt.rs:359-371) and a cascade of second-order sections
(iirfilt.rs:377-383). Block processing is a lax.scan over time — the
recurrence is sequential by nature; channels batch through the scan body.
Special constructors: Butterworth lowpass, DC blocker, PLL loop filter, and
the 8th-order Pintelon-Schoukens integrator/differentiator
(iirfilt.rs:204-262).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from ..design import iir as iirdes
from .iirfiltsos import IirFilterSos

__all__ = ["IirFilter"]


def _polar(mag, deg):
    return mag * np.exp(1j * np.pi / 180.0 * deg)


@struct.pytree
class IirFilter:
    """IIR filter state (iirfilt.rs:25-38).

    ``sos`` realization: B/A are [nsos, 3]; state v is [..., nsos, 2].
    ``norm`` realization: b [nb], a [na]; state v is [..., n-1] window of
    previous direct-form-II values (newest first).
    """

    sos_form: bool = struct.static_field()
    b: jnp.ndarray = struct.field()
    a: jnp.ndarray = struct.field()
    scale: jnp.ndarray = struct.field()
    v: jnp.ndarray = struct.field()
    # log-depth block path (associative scan over the linear recurrence,
    # filter/_linrec.py) — fp32-tolerance-equal to the sequential scan,
    # log-depth instead of one scan step per sample
    parallel: bool = struct.static_field(default=False)

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, b, a, batch_shape: tuple = (), dtype=jnp.float32) -> "IirFilter":
        """TF form from b/a (iirfilt.rs:66); coefficients normalized by a[0]."""
        b = np.atleast_1d(np.asarray(b))
        a = np.atleast_1d(np.asarray(a))
        if b.size == 0:
            raise ConfigError("numerator length cannot be zero")
        if a.size == 0:
            raise ConfigError("denominator length cannot be zero")
        if a.flat[0] == 0:
            raise ConfigError("a[0] cannot be zero")
        n = max(len(a), len(b))
        cdt = np.complex64 if (np.iscomplexobj(b) or np.iscomplexobj(a)) else np.float32
        bp = np.zeros(n, dtype=cdt)
        ap = np.zeros(n, dtype=cdt)
        bp[: len(b)] = (b / a.flat[0]).astype(cdt)
        ap[: len(a)] = (a / a.flat[0]).astype(cdt)
        return cls(
            sos_form=False,
            b=jnp.asarray(bp),
            a=jnp.asarray(ap),
            scale=jnp.asarray(1.0, dtype=cdt),
            v=jnp.zeros(batch_shape + (n - 1,), dtype=jnp.dtype(dtype)),
        )

    @classmethod
    def create_sos(cls, B, A, batch_shape: tuple = (), dtype=jnp.float32) -> "IirFilter":
        """SOS cascade from [nsos, 3] matrices (iirfilt.rs:110)."""
        B = np.asarray(B, dtype=np.float64).reshape(-1, 3)
        A = np.asarray(A, dtype=np.float64).reshape(-1, 3)
        if len(B) == 0 or len(B) != len(A):
            raise ConfigError("filter must have at least one 2nd-order section")
        a0 = A[:, :1]
        B = B / a0
        A = A / a0
        return cls(
            sos_form=True,
            b=jnp.asarray(B, dtype=jnp.float32),
            a=jnp.asarray(A, dtype=jnp.float32),
            scale=jnp.asarray(1.0, dtype=jnp.float32),
            v=jnp.zeros(batch_shape + (len(B), 2), dtype=jnp.dtype(dtype)),
        )

    @classmethod
    def create_prototype(
        cls,
        ftype: iirdes.IirFilterShape,
        btype: iirdes.IirBandType,
        fmt: iirdes.IirFormat,
        order: int,
        fc: float,
        f0: float = 0.0,
        ap: float = 0.1,
        as_: float = 60.0,
        **kw,
    ) -> "IirFilter":
        """Design + realize (iirfilt.rs:148-184)."""
        b, a = iirdes.iir_design(ftype, btype, fmt, order, fc, f0, ap, as_)
        if fmt == iirdes.IirFormat.SECOND_ORDER_SECTIONS:
            return cls.create_sos(b, a, **kw)
        return cls.create(b, a, **kw)

    @classmethod
    def create_lowpass(cls, order: int, fc: float, **kw) -> "IirFilter":
        """Butterworth lowpass in SOS form (iirfilt.rs:189)."""
        return cls.create_prototype(
            iirdes.IirFilterShape.BUTTER,
            iirdes.IirBandType.LOWPASS,
            iirdes.IirFormat.SECOND_ORDER_SECTIONS,
            order,
            fc,
            0.0,
            0.1,
            60.0,
            **kw,
        )

    @classmethod
    def create_dc_blocker(cls, alpha: float, **kw) -> "IirFilter":
        """H(z) = (1-z⁻¹)/(1-(1-α)z⁻¹), scaled √(1-α) (iirfilt.rs:290)."""
        if alpha <= 0.0:
            raise ConfigError("DC-blocking filter bandwidth must be greater than zero")
        f = cls.create([1.0, -1.0], [1.0, -1.0 + alpha], **kw)
        return f.set_scale(float(np.sqrt(1.0 - alpha)))

    @classmethod
    def create_pll(cls, w: float, zeta: float, k: float, **kw) -> "IirFilter":
        """PLL loop filter as one SOS (iirfilt.rs:307)."""
        if w <= 0.0 or w >= 1.0:
            raise ConfigError("PLL bandwidth must be in (0,1)")
        if zeta <= 0.0 or zeta >= 1.0:
            raise ConfigError("PLL damping factor must be in (0,1)")
        if k <= 0.0:
            raise ConfigError("PLL loop gain must be greater than zero")
        b, a = iirdes.iir_design_pll_active_lag(w, zeta, k)
        return cls.create_sos(b.reshape(1, 3), a.reshape(1, 3), **kw)

    @classmethod
    def create_integrator(cls, **kw) -> "IirFilter":
        """8th-order integrator, [Pintelon:1990] Table II (iirfilt.rs:204)."""
        zdi = np.array(
            [
                -1.175839,
                _polar(3.371020, -125.1125),
                _polar(3.371020, 125.1125),
                _polar(4.549710, -80.96404),
                _polar(4.549710, 80.96404),
                _polar(5.223966, -40.09347),
                _polar(5.223966, 40.09347),
                5.443743,
            ]
        )
        pdi = np.array(
            [
                -0.5805235,
                _polar(0.2332021, -114.0968),
                _polar(0.2332021, 114.0968),
                _polar(0.1814755, -66.33969),
                _polar(0.1814755, 66.33969),
                _polar(0.1641457, -21.89539),
                _polar(0.1641457, 21.89539),
                1.0,
            ]
        )
        kdi = -1.89213380759321e-05 / 0.9695401191711425781
        B, A = iirdes.iir_design_d2sos(zdi, pdi, kdi)
        return cls.create_sos(B, A, **kw)

    @classmethod
    def create_differentiator(cls, **kw) -> "IirFilter":
        """8th-order differentiator, [Pintelon:1990] Table IV (iirfilt.rs:234)."""
        zdd = np.array(
            [
                -1.702575,
                _polar(5.877385, -221.4063),
                _polar(5.877385, 221.4063),
                _polar(4.197421, -144.5972),
                _polar(4.197421, 144.5972),
                _polar(5.350284, -66.88802),
                _polar(5.350284, 66.88802),
                1.0,
            ]
        )
        pdd = np.array(
            [
                -0.8476936,
                _polar(0.2990781, -125.5188),
                _polar(0.2990781, 125.5188),
                _polar(0.2232427, -81.52326),
                _polar(0.2232427, 81.52326),
                _polar(0.1958670, -40.51510),
                _polar(0.1958670, 40.51510),
                0.1886088,
            ]
        )
        kdd = 2.09049284907492e-05 / 1.033477783203125000
        B, A = iirdes.iir_design_d2sos(zdd, pdd, kdd)
        return cls.create_sos(B, A, **kw)

    # ------------------------------------------------------------- streaming
    @property
    def nsos(self) -> int:
        return self.b.shape[0] if self.sos_form else 0

    def get_length(self) -> int:
        """Filter length, order+1 (iirfilt.rs:409)."""
        return 2 * self.nsos if self.sos_form else self.b.shape[0]

    def reset(self) -> "IirFilter":
        return self.replace(v=jnp.zeros_like(self.v))

    def parallelize(self) -> "IirFilter":
        """Switch block processing to the log-depth associative-scan path.

        Same recurrence, different summation order: outputs match the
        sequential scan to fp32 tolerance (tests/test_iir_parallel.py), and
        the state carry keeps block-split invariance. Use for long blocks;
        keep the default sequential path when bit-compatibility with
        per-sample execution matters.
        """
        return self.replace(parallel=True)

    def _execute_block_parallel(self, x) -> tuple[jnp.ndarray, "IirFilter"]:
        from ._linrec import allpole_parallel

        if self.sos_form:
            B, A = self.b, self.a
            y = x
            vs = []
            for s in range(self.nsos):
                v0, v_fin = allpole_parallel(A[s, 1:], self.v[..., s, :], y)
                # numerator: y[n] = b0·v0[n] + b1·v0[n−1] + b2·v0[n−2]
                ext = jnp.concatenate(
                    [self.v[..., s, ::-1].astype(v0.dtype), v0], axis=-1
                )
                T = x.shape[-1]
                y = (
                    B[s, 0] * ext[..., 2 : 2 + T]
                    + B[s, 1] * ext[..., 1 : 1 + T]
                    + B[s, 2] * ext[..., 0:T]
                )
                vs.append(v_fin)
            v_final = jnp.stack(vs, axis=-2)
        else:
            b, a = self.b, self.a
            m = b.shape[0] - 1
            v0, v_final = allpole_parallel(a[1:], self.v, x)
            ext = jnp.concatenate([self.v[..., ::-1].astype(v0.dtype), v0], axis=-1)
            T = x.shape[-1]
            y = sum(b[k] * ext[..., m - k : m - k + T] for k in range(m + 1))
        y = y * self.scale
        if not jnp.iscomplexobj(self.v):
            v_final = v_final.real.astype(self.v.dtype) if jnp.iscomplexobj(
                v_final
            ) else v_final.astype(self.v.dtype)
        return y, self.replace(v=v_final)

    def execute_block(self, x) -> tuple[jnp.ndarray, "IirFilter"]:
        """Block execute via time scan (iirfilt.rs:396)."""
        x = jnp.asarray(x)
        if self.parallel:
            return self._execute_block_parallel(x)
        xt = jnp.moveaxis(x, -1, 0)

        from ..utils.planar import loop_constants, planar_scan

        if self.sos_form:
            B, A = self.b, self.a
            nsos = self.nsos
            # per-section coefficient scalars materialized outside the scan
            # (in-body A[s,i] slices get sunk into every iteration)
            like = self.v[..., 0, 0]
            coef = loop_constants(
                *[A[s, i] for s in range(nsos) for i in (1, 2)],
                *[B[s, i] for s in range(nsos) for i in (0, 1, 2)],
                like=like,
            )
            A12 = [(coef[2 * s], coef[2 * s + 1]) for s in range(nsos)]
            B012 = [
                (coef[2 * nsos + 3 * s], coef[2 * nsos + 3 * s + 1],
                 coef[2 * nsos + 3 * s + 2])
                for s in range(nsos)
            ]

            def step(v, xi):
                y = xi
                vs = []
                for s in range(nsos):
                    v1 = v[..., s, 0]
                    v2 = v[..., s, 1]
                    v0 = y - A12[s][0] * v1 - A12[s][1] * v2
                    y = B012[s][0] * v0 + B012[s][1] * v1 + B012[s][2] * v2
                    vs.append(jnp.stack([v0, v1], axis=-1))
                return jnp.stack(vs, axis=-2), y

        else:
            b, a = self.b, self.a
            b0 = loop_constants(b[0], like=self.v[..., 0])

            def step(v, xi):
                # v holds previous DF-II values, newest first (length n-1)
                v0 = xi - jnp.sum(a[1:] * v, axis=-1)
                y = b0 * v0 + jnp.sum(b[1:] * v, axis=-1)
                v_new = jnp.concatenate([v0[..., None], v[..., :-1]], axis=-1)
                return v_new, y

        v_final, yt = planar_scan(step, self.v, xt, unroll=8)
        y = jnp.moveaxis(yt, 0, -1) * self.scale
        return y, self.replace(v=v_final)

    __call__ = execute_block

    def execute(self, x):
        """Single-sample parity (iirfilt.rs:388)."""
        y, q = self.execute_block(jnp.asarray(x)[..., None])
        return y[..., 0], q

    def set_scale(self, scale) -> "IirFilter":
        return self.replace(scale=jnp.asarray(scale, dtype=self.scale.dtype))

    def get_scale(self):
        return self.scale

    # ------------------------------------------------------------- analysis
    def freqresponse(self, fc: float) -> complex:
        """Frequency response at fc (iirfilt.rs:413ff)."""
        if self.sos_form:
            B = np.asarray(self.b)
            A = np.asarray(self.a)
            h = complex(np.asarray(self.scale))
            w = np.exp(-2j * np.pi * fc * np.arange(3))
            for s in range(len(B)):
                h *= np.sum(B[s] * w) / np.sum(A[s] * w)
            return h
        b = np.asarray(self.b)
        a = np.asarray(self.a)
        w = np.exp(-2j * np.pi * fc * np.arange(len(b)))
        return complex(np.asarray(self.scale)) * complex(np.sum(b * w) / np.sum(a * w))

    def groupdelay(self, fc: float) -> float:
        """Group delay (iirfilt.rs:459-478)."""
        if self.sos_form:
            B = np.asarray(self.b)
            A = np.asarray(self.a)
            return float(
                sum(iirdes.iir_group_delay(B[s], A[s], fc) for s in range(len(B)))
            )
        return iirdes.iir_group_delay(np.asarray(self.b).real, np.asarray(self.a).real, fc)
