"""Linear modulator/demodulator — 52 schemes.

Behavioral spec: /root/reference/src/modem/modem.rs + submodules (psk, dpsk,
ask, qam, apsk, bpsk, qpsk, ook, sqam32/128, pi4dqpsk, V.29, arb*opt,
arb64vt/ui, arbitrary tables). Block-parallel design:

* Every memoryless scheme is materialized as a constellation table [M]
  (complex64) with liquid's exact gray coding and normalization; block
  modulation is ONE gather, block demodulation is ONE argmin over
  |x - table|² (lowered to a matmul form). liquid's
  scheme-specific slicers (psk.rs:62, qam.rs:103, apsk.rs:87, ...) are
  decision-region-equivalent to nearest-neighbor on the same table.
* Differential schemes (DPSK, π/4-DQPSK) carry a phase state; block
  modulation uses a cumulative phase sum, block demodulation uses
  consecutive-sample phase differences — both vectorized, bit-equal to the
  reference's per-symbol loop.
* Soft demodulation uses liquid's nearest-neighbor table approximation
  (modem.rs:317-364) with exact LLR forms for BPSK/QPSK (bpsk.rs:22,
  qpsk.rs:24); softbit convention 0/127/255 (modem.rs:23-25).

Constellation data (APSK ring definitions, V.29, optimal QAM tables, logo
constellations, sqam quadrant maps) lives in ``data/*.json``, extracted from
the reference's published tables by tools/extract_constellations.py.
"""

from __future__ import annotations

import enum
import json
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError

__all__ = [
    "ModulationScheme",
    "Modem",
    "gray_encode",
    "gray_decode",
]

_DATA = Path(__file__).parent / "data"

SOFTBIT_0 = 0
SOFTBIT_ERASURE = 127
SOFTBIT_1 = 255
_MAX_BPS = 8


class ModulationScheme(enum.Enum):
    """Scheme taxonomy (modem.rs:28-79)."""

    PSK2 = "psk2"; PSK4 = "psk4"; PSK8 = "psk8"; PSK16 = "psk16"
    PSK32 = "psk32"; PSK64 = "psk64"; PSK128 = "psk128"; PSK256 = "psk256"
    DPSK2 = "dpsk2"; DPSK4 = "dpsk4"; DPSK8 = "dpsk8"; DPSK16 = "dpsk16"
    DPSK32 = "dpsk32"; DPSK64 = "dpsk64"; DPSK128 = "dpsk128"; DPSK256 = "dpsk256"
    ASK2 = "ask2"; ASK4 = "ask4"; ASK8 = "ask8"; ASK16 = "ask16"
    ASK32 = "ask32"; ASK64 = "ask64"; ASK128 = "ask128"; ASK256 = "ask256"
    QAM4 = "qam4"; QAM8 = "qam8"; QAM16 = "qam16"; QAM32 = "qam32"
    QAM64 = "qam64"; QAM128 = "qam128"; QAM256 = "qam256"
    APSK4 = "apsk4"; APSK8 = "apsk8"; APSK16 = "apsk16"; APSK32 = "apsk32"
    APSK64 = "apsk64"; APSK128 = "apsk128"; APSK256 = "apsk256"
    BPSK = "bpsk"; QPSK = "qpsk"; OOK = "ook"
    SQAM32 = "sqam32"; SQAM128 = "sqam128"; V29 = "V29"
    ARB16OPT = "arb16opt"; ARB32OPT = "arb32opt"; ARB64OPT = "arb64opt"
    ARB128OPT = "arb128opt"; ARB256OPT = "arb256opt"
    ARB64VT = "arb64vt"; ARB64UI = "arb64ui"
    PI4DQPSK = "pi4dqpsk"
    ARB = "arb"

    @classmethod
    def from_str(cls, s: str) -> "ModulationScheme":
        for sch in cls:
            if sch.value.lower() == s.lower():
                return sch
        raise ConfigError(f"unknown modulation scheme {s!r}")


def gray_encode(sym):
    """s ^ (s >> 1) (modem.rs:516)."""
    sym = np.asarray(sym)
    return sym ^ (sym >> 1)


def gray_decode(sym):
    """Inverse gray code: b = g ^ (g>>1) ^ (g>>2) ^ ... (modem.rs:521)."""
    g = np.asarray(sym)
    b = g.copy()
    for shift in range(1, 32):
        b = b ^ (g >> shift)
    return b


_gray_decode_loop = gray_decode


# ---------------------------------------------------------------- tables
@lru_cache(maxsize=1)
def _arb_tables() -> dict:
    with open(_DATA / "arb_constellations.json") as f:
        raw = json.load(f)
    return {
        k: np.array([complex(a, b) for a, b in v], dtype=np.complex64)
        for k, v in raw.items()
    }


@lru_cache(maxsize=1)
def _apsk_defs() -> dict:
    with open(_DATA / "apsk.json") as f:
        return json.load(f)


_ASK_ALPHA = {
    2: 1.0, 4: 1 / np.sqrt(5), 8: 1 / np.sqrt(21), 16: 1 / np.sqrt(85),
    32: 1 / np.sqrt(341), 64: 1 / np.sqrt(1365), 128: 1 / np.sqrt(5461),
    256: 1 / np.sqrt(21845),
}
_QAM_ALPHA = {
    4: 1 / np.sqrt(2), 8: 1 / np.sqrt(6), 16: 1 / np.sqrt(10),
    32: 1 / np.sqrt(26), 64: 1 / np.sqrt(42), 128: 1 / np.sqrt(106),
    256: 1 / np.sqrt(170),
}


def _expand_quadrant(submap: np.ndarray, bits_sub: int) -> np.ndarray:
    """sqam32/128 full table: quadrant bits select conj/negation
    (sqam32.rs:17-35)."""
    M = 4 << bits_sub
    table = np.empty(M, dtype=np.complex64)
    for sym in range(M):
        quad = (sym >> bits_sub) & 0x03
        p = submap[sym & ((1 << bits_sub) - 1)]
        table[sym] = [p, np.conj(p), -np.conj(p), -p][quad]
    return table


def build_constellation(scheme: ModulationScheme, table=None) -> np.ndarray:
    """Constellation table[sym] for every memoryless scheme."""
    name = scheme.value
    if scheme == ModulationScheme.ARB:
        if table is None:
            raise ConfigError("arbitrary scheme requires a table")
        t = np.asarray(table, dtype=np.complex64)
        if len(t) & (len(t) - 1):
            raise ConfigError("table size must be power of 2")
        return t

    if name.startswith("psk"):
        M = int(name[3:])
        syms = np.arange(M)
        return np.exp(2j * np.pi * _gray_decode_loop(syms) / M).astype(np.complex64)

    if name.startswith("ask"):
        M = int(name[3:])
        alpha = _ASK_ALPHA[M]
        syms = _gray_decode_loop(np.arange(M))
        return ((2 * syms - M + 1) * alpha).astype(np.complex64)

    if name.startswith("qam"):
        M = int(name[3:])
        bps = int(np.log2(M))
        alpha = _QAM_ALPHA[M]
        m_i = (bps + 1) // 2 if bps % 2 else bps // 2
        m_q = bps - m_i
        Mi, Mq = 1 << m_i, 1 << m_q
        syms = np.arange(M)
        s_i = _gray_decode_loop(syms >> m_q)
        s_q = _gray_decode_loop(syms & (Mq - 1))
        return (
            (2 * s_i - Mi + 1) * alpha + 1j * (2 * s_q - Mq + 1) * alpha
        ).astype(np.complex64)

    if name.startswith("apsk"):
        M = int(name[4:])
        d = _apsk_defs()[str(M)]
        p, r, phi, mp = d["p"], d["r"], d["phi"], d["map"]
        table = np.empty(M, dtype=np.complex64)
        for sym in range(M):
            s = mp[sym]
            t = 0
            level = 0
            for i, pi in enumerate(p):
                if s < t + pi:
                    level = i
                    break
                t += pi
            s0 = s - t
            ang = phi[level] + s0 * 2.0 * np.pi / p[level]
            table[sym] = r[level] * np.exp(1j * ang)
        return table

    if scheme == ModulationScheme.BPSK:
        return np.array([1.0, -1.0], dtype=np.complex64)
    if scheme == ModulationScheme.QPSK:
        s = 1 / np.sqrt(2)
        return np.array(
            [s + 1j * s, -s + 1j * s, s - 1j * s, -s - 1j * s], dtype=np.complex64
        )
    if scheme == ModulationScheme.OOK:
        return np.array([np.sqrt(2.0), 0.0], dtype=np.complex64)
    if scheme == ModulationScheme.SQAM32:
        return _expand_quadrant(_arb_tables()["sqam32_quadrant"], 3)
    if scheme == ModulationScheme.SQAM128:
        return _expand_quadrant(_arb_tables()["sqam128_quadrant"], 5)
    if scheme == ModulationScheme.V29:
        return _arb_tables()["v29"]
    if name.startswith("arb"):
        return _arb_tables()[name]

    raise ConfigError(f"scheme {scheme} has no static constellation")


def _soft_neighbors(table: np.ndarray, p: int) -> np.ndarray:
    """p nearest neighbors per constellation point (modem.rs init_demod_soft_tab)."""
    M = len(table)
    d = np.abs(table[:, None] - table[None, :])
    np.fill_diagonal(d, np.inf)
    return np.argsort(d, axis=1)[:, :p].astype(np.int32)


def _soft_p_for(scheme: ModulationScheme, bps: int) -> int:
    """Neighbor count per scheme (psk.rs:44, qam.rs:71, apsk.rs:40)."""
    name = scheme.value
    if name.startswith("apsk"):
        return {2: 3, 3: 3, 4: 4, 5: 4, 6: 4, 7: 5, 8: 5}[bps]
    if name.startswith("qam") or name.startswith("sqam") or name.startswith("arb") or name in ("V29",):
        return 3 if bps == 3 else 4 if bps >= 4 else 2
    return 2


_DIFFERENTIAL = {
    ModulationScheme.DPSK2, ModulationScheme.DPSK4, ModulationScheme.DPSK8,
    ModulationScheme.DPSK16, ModulationScheme.DPSK32, ModulationScheme.DPSK64,
    ModulationScheme.DPSK128, ModulationScheme.DPSK256, ModulationScheme.PI4DQPSK,
}


@struct.pytree
class Modem:
    """Modem state (modem.rs:82-121)."""

    scheme: ModulationScheme = struct.static_field()
    bits_per_symbol: int = struct.static_field()
    table: jnp.ndarray = struct.field()  # [M] constellation (dummy for dpsk)
    soft_neighbors: jnp.ndarray = struct.field()  # [M, p] int32
    # demod state (last sample)
    r: jnp.ndarray = struct.field()
    x_hat: jnp.ndarray = struct.field()
    # differential phase state
    phi: jnp.ndarray = struct.field()
    # msequence randomizer state (for random_symbol)
    rand_state: jnp.ndarray = struct.field()

    # ------------------------------------------------------------------ ctor
    @classmethod
    def create(cls, scheme, table=None, batch_shape: tuple = ()) -> "Modem":
        if isinstance(scheme, str):
            scheme = ModulationScheme.from_str(scheme)
        if scheme in _DIFFERENTIAL:
            if scheme == ModulationScheme.PI4DQPSK:
                bps = 2
                tab = np.exp(
                    1j * np.array([0.25, 0.75, -0.25, -0.75]) * np.pi
                ).astype(np.complex64)  # per-symbol phase increments
            else:
                M = int(scheme.value[4:])
                bps = int(np.log2(M))
                tab = np.exp(
                    2j * np.pi * _gray_decode_loop(np.arange(M)) / M
                ).astype(np.complex64)  # increment table
            neigh = np.zeros((len(tab), 1), dtype=np.int32)
        else:
            tab = build_constellation(scheme, table)
            bps = int(np.log2(len(tab)))
            p = _soft_p_for(scheme, bps)
            neigh = _soft_neighbors(tab, p)
        return cls(
            scheme=scheme,
            bits_per_symbol=bps,
            table=jnp.asarray(tab),
            soft_neighbors=jnp.asarray(neigh),
            r=jnp.full(batch_shape, 1.0 + 0j, dtype=jnp.complex64),
            x_hat=jnp.full(batch_shape, 1.0 + 0j, dtype=jnp.complex64),
            phi=jnp.zeros(batch_shape, dtype=jnp.float32),
            rand_state=jnp.full(batch_shape, 1, dtype=jnp.uint32),
        )

    @classmethod
    def from_table(cls, table, **kw) -> "Modem":
        """Arbitrary constellation (modem.rs:209)."""
        return cls.create(ModulationScheme.ARB, table=table, **kw)

    # ------------------------------------------------------------ properties
    @property
    def constellation_size(self) -> int:
        return 1 << self.bits_per_symbol

    def get_bps(self) -> int:
        return self.bits_per_symbol

    def get_scheme(self) -> ModulationScheme:
        return self.scheme

    def reset(self) -> "Modem":
        return self.replace(
            r=jnp.ones_like(self.r),
            x_hat=jnp.ones_like(self.x_hat),
            phi=jnp.zeros_like(self.phi),
        )

    # ------------------------------------------------------------- modulate
    def modulate(self, symbols) -> tuple[jnp.ndarray, "Modem"]:
        """Map symbols [..., N] → samples (modem.rs:243).

        Differential schemes accumulate phase with a cumulative product of
        increments seeded by the carried state.
        """
        symbols = jnp.asarray(symbols)
        # out-of-range symbols clip to M-1 (the reference raises Config at
        # call time, modem.rs:244; clipping is the jit-safe equivalent)
        if self.scheme in _DIFFERENTIAL:
            inc = jnp.take(self.table, symbols, axis=0, mode="clip")
            rot = jnp.cumprod(inc, axis=-1)
            base = jnp.exp(1j * self.phi)[..., None]
            y = base * rot
            new_phi = jnp.angle(y[..., -1])
            return y, self.replace(phi=new_phi)
        y = jnp.take(self.table, symbols, axis=0, mode="clip")
        return y, self

    # ------------------------------------------------------------ demodulate
    def _nearest(self, x):
        """argmin_s |x - table[s]|² vectorized over the block."""
        d = jnp.abs(x[..., None] - self.table[None, :]) ** 2
        return jnp.argmin(d, axis=-1).astype(jnp.uint32)

    def demodulate(self, x) -> tuple[jnp.ndarray, "Modem"]:
        """Hard-decision demod of a block (modem.rs:255)."""
        x = jnp.asarray(x)
        if self.scheme in _DIFFERENTIAL or self.scheme == ModulationScheme.PI4DQPSK:
            sym, _, new = self._demodulate_diff_full(x)
            return sym, new
        sym = self._nearest(x)
        x_hat = jnp.take(self.table, sym, axis=0)
        return sym, self.replace(r=x[..., -1], x_hat=x_hat[..., -1])

    def _demodulate_diff_full(self, x):
        """Differential demod returning the per-sample ideal x̂ sequence."""
        if self.scheme == ModulationScheme.PI4DQPSK:
            theta = jnp.angle(x)
            prev = jnp.concatenate([self.phi[..., None], theta[..., :-1]], axis=-1)
            d_theta = jnp.mod(theta - prev + np.pi, 2 * np.pi) - np.pi
            sym = jnp.where(
                d_theta > 0.5 * np.pi, 1,
                jnp.where(d_theta > 0.0, 0, jnp.where(d_theta < -0.5 * np.pi, 3, 2)),
            ).astype(jnp.uint32)
            ideal = jnp.take(
                jnp.asarray([0.25, 0.75, -0.25, -0.75]) * np.pi, sym, axis=0
            )
            x_hat = jnp.exp(1j * (prev + ideal)).astype(jnp.complex64)
            return sym, x_hat, self.replace(
                phi=theta[..., -1], r=x[..., -1], x_hat=x_hat[..., -1]
            )
        if True:  # DPSK (only remaining differential scheme here)
            M = self.constellation_size
            alpha = np.pi / M
            d_phi_off = np.pi * (1.0 - 1.0 / M)
            theta = jnp.angle(x)
            prev = jnp.concatenate([self.phi[..., None], theta[..., :-1]], axis=-1)
            d_theta = theta - prev - d_phi_off
            d_theta = jnp.mod(d_theta + np.pi, 2 * np.pi) - np.pi
            # nearest multiple of 2α above -π+... : linear slicer
            s = jnp.clip(
                jnp.round((d_theta + d_phi_off) / (2 * alpha)), 0, M - 1
            ).astype(jnp.uint32)
            sym = jnp.asarray(gray_encode(np.arange(M)), dtype=jnp.uint32)[s]
            res = (d_theta + d_phi_off) - s.astype(jnp.float32) * 2 * alpha
            x_hat = jnp.exp(1j * (theta - res)).astype(jnp.complex64)
            return sym, x_hat, self.replace(
                phi=theta[..., -1], r=x[..., -1], x_hat=x_hat[..., -1]
            )

    def demodulate_with_stats(self, x):
        """(symbols, x_hat, phase_error, evm) per sample (modem.rs:277-283).

        Differential schemes use the reconstructed per-sample ideal point
        (unit modulus at the decided differential angle), matching the
        reference's carried r/x_hat stats.
        """
        x = jnp.asarray(x)
        if self.scheme in _DIFFERENTIAL or self.scheme == ModulationScheme.PI4DQPSK:
            sym, x_hat, new_self = self._demodulate_diff_full(x)
        else:
            sym, new_self = self.demodulate(x)
            x_hat = jnp.take(self.table, sym, axis=0)
        phase_error = (x * jnp.conj(x_hat)).imag
        evm = jnp.abs(x_hat - x)
        return sym, x_hat, phase_error, evm, new_self

    def get_demodulator_sample(self):
        return self.x_hat

    def get_demodulator_phase_error(self):
        """Im(r·x̂*) (modem.rs:277)."""
        return (self.r * jnp.conj(self.x_hat)).imag

    def get_demodulator_evm(self):
        """|x̂ - r| (modem.rs:281)."""
        return jnp.abs(self.x_hat - self.r)

    # ------------------------------------------------------------- soft demod
    def demodulate_soft(
        self, x, compat: bool = False
    ) -> tuple[jnp.ndarray, jnp.ndarray, "Modem"]:
        """Soft bits [..., N, bps] in 0..255 (modem.rs:259-271).

        BPSK/QPSK use exact LLRs (bpsk.rs:22, qpsk.rs:24); table schemes use
        the nearest-neighbor approximation (modem.rs:317-364); differential
        schemes fall back to hard bits.

        ``compat=True`` reproduces the reference's TRUNCATING byte cast on
        the table path (modem.rs:358-360 ``as u8``) bit-for-bit; the default
        rounds to nearest, which keeps weak-1 LLRs off the 127 erasure value
        (COMPAT.md divergence #6).
        """
        x = jnp.asarray(x)
        bps = self.bits_per_symbol

        if self.scheme == ModulationScheme.BPSK:
            sym, new_self = self.demodulate(x)
            llr = -2.0 * x.real * 4.0
            soft = jnp.clip(llr * 16.0 + 127.0, 0, 255).astype(jnp.uint8)
            return sym, soft[..., None], new_self

        if self.scheme == ModulationScheme.QPSK:
            sym, new_self = self.demodulate(x)
            llr0 = -2.0 * x.imag * 5.8
            llr1 = -2.0 * x.real * 5.8
            soft = jnp.stack(
                [
                    jnp.clip(llr0 * 16.0 + 127.0, 0, 255),
                    jnp.clip(llr1 * 16.0 + 127.0, 0, 255),
                ],
                axis=-1,
            ).astype(jnp.uint8)
            return sym, soft, new_self

        if self.scheme in _DIFFERENTIAL:
            sym, new_self = self.demodulate(x)
            bits = (sym[..., None] >> jnp.arange(bps - 1, -1, -1)) & 1
            return sym, (bits * 255).astype(jnp.uint8), new_self

        sym, new_self = self.demodulate(x)
        x_hat = jnp.take(self.table, sym, axis=0)
        gamma = 1.2 * self.constellation_size

        d0 = jnp.abs(x - x_hat) ** 2
        k = jnp.arange(bps - 1, -1, -1)
        bits_self = (sym[..., None] >> k) & 1  # [..., bps]
        big = jnp.float32(8.0)
        dmin1 = jnp.where(bits_self == 1, d0[..., None], big)
        dmin0 = jnp.where(bits_self == 0, d0[..., None], big)

        neigh = jnp.take(self.soft_neighbors, sym, axis=0)  # [..., p]
        x_n = jnp.take(self.table, neigh, axis=0)  # [..., p]
        d_n = jnp.abs(x[..., None] - x_n) ** 2  # [..., p]
        bits_n = (neigh[..., None] >> k) & 1  # [..., p, bps]
        dn1 = jnp.where(bits_n == 1, d_n[..., None], big).min(axis=-2)
        dn0 = jnp.where(bits_n == 0, d_n[..., None], big).min(axis=-2)
        dmin1 = jnp.minimum(dmin1, dn1)
        dmin0 = jnp.minimum(dmin0, dn0)

        # round-to-nearest by default (NOT the reference's truncating cast,
        # modem.rs:358-360): for dense constellations (ask256) the LSB
        # confidence is ~0.9 quantum, which truncation collapses onto the
        # erasure value 127 and pack_soft_bits then mis-decodes — rounding
        # keeps any positive LLR strictly above erasure. compat=True keeps
        # the reference's truncation for bit-exact conformance.
        scaled = jnp.clip((dmin0 - dmin1) * gamma * 16.0 + 127.0, 0, 255)
        soft = (scaled if compat else jnp.round(scaled)).astype(jnp.uint8)
        return sym, soft, new_self

    # -------------------------------------------------------------- sources
    def random_symbol(self, key):
        """Uniform random symbol via jax.random (reference uses its internal
        MSequence, modem.rs:238; seeded jax.random is the native source)."""
        return jax.random.randint(key, (), 0, self.constellation_size, dtype=jnp.uint32)

    def random_symbols(self, key, shape):
        return jax.random.randint(key, shape, 0, self.constellation_size, dtype=jnp.uint32)
