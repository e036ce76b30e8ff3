"""Convolutional codes with a vectorized Viterbi decoder.

Fills the reference's empty fec module; behavioral spec is liquid-dsp's
convolutional set (LIQUID_COMPAT.md fec rows): the ka9q codes
V27 (K=7, r=1/2), V29 (K=9, r=1/2), V39 (K=9, r=1/3), V615 (K=15, r=1/6),
plus punctured rates p/(p+1) for p in 2..7 on the K=7 and K=9 base codes.

Block-parallel design:

- **Encode** is binary convolution mod 2: output stream j is
  ``convolve(x, g_j) & 1`` — one pass of vectorized numpy (or an XLA conv);
  no per-bit shift-register loop.
- **Decode** is the classic SIMD-Viterbi layout as a ``lax.scan`` over
  time: the scan body performs one add-compare-select across *all*
  2^(K-1) path metrics at once (pure vector ops — gathers, adds, minima),
  storing one decision bit per state per step; a second scan runs the
  traceback. States are the vector axis, so the device processes
  the whole trellis column per cycle group. Soft-decision input: each
  received level in [0,1] (0.5 = erasure, which is how punctured
  positions are filled).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..errors import ConfigError

__all__ = [
    "ConvCode", "PuncturedConvCode", "conv27", "conv29", "conv39", "conv615",
    "conv_punctured",
]

# ka9q / liquid generator polynomials (bit i of poly taps x[n-i])
_V27_POLYS = (0x6D, 0x4F)
_V29_POLYS = (0x1AF, 0x11D)
_V39_POLYS = (0x1ED, 0x19B, 0x127)
_V615_POLYS = (0o42631, 0o47245, 0o56507, 0o73363, 0o77267, 0o64537)


class ConvCode:
    """Rate-1/R, constraint-length-K convolutional code."""

    def __init__(self, K: int, polys, name: str):
        self.K = int(K)
        self.polys = tuple(int(p) for p in polys)
        self.R = len(self.polys)
        self.name = name
        self.rate = 1.0 / self.R
        for p in self.polys:
            if p >= (1 << self.K):
                raise ConfigError(f"poly {p:#o} exceeds constraint length {K}")
        S = 1 << (self.K - 1)
        # expected outputs for (prev_state p, input b): full = (p<<1)|b
        full = ((np.arange(S)[:, None] << 1) | np.arange(2)[None, :])  # [S,2]
        outs = np.zeros((S, 2, self.R), dtype=np.float32)
        for j, poly in enumerate(self.polys):
            v = full & poly
            outs[:, :, j] = (np.bitwise_count(v.astype(np.uint64)) & 1)
        self._expected = outs                                # [S, 2, R]
        half = S >> 1
        ns = np.arange(S)
        self._prev0 = (ns >> 1).astype(np.int32)             # [S]
        self._prev1 = ((ns >> 1) | half).astype(np.int32)    # [S]
        self._in_bit = (ns & 1).astype(np.int32)             # input bit = ns&1

    # ---------------- encode ----------------

    def encode_bits(self, bits) -> np.ndarray:
        """Data bits [L] -> coded bits [R*(L+K-1)] (K-1 flush zeros),
        outputs interleaved per input bit (ka9q order A,B,...)."""
        bits = np.asarray(bits, dtype=np.uint8).ravel() & 1
        L = bits.shape[0]
        T = L + self.K - 1
        out = np.zeros((T, self.R), dtype=np.uint8)
        for j, poly in enumerate(self.polys):
            g = ((poly >> np.arange(self.K)) & 1).astype(np.uint8)
            out[:, j] = np.convolve(bits, g)[:T] & 1
        return out.reshape(-1)

    # ---------------- decode ----------------

    def decode_soft(self, levels, msg_len: int) -> np.ndarray:
        """Soft-decision Viterbi. ``levels`` [R*(msg_len+K-1)] in [0,1]
        (1 = confident one, 0 = confident zero, 0.5 = erasure). Returns
        decoded data bits [msg_len]."""
        levels = np.asarray(levels, dtype=np.float32).reshape(-1, self.R)
        T = msg_len + self.K - 1
        if levels.shape[0] != T:
            raise ConfigError(
                f"received length {levels.shape[0]} != msg_len+K-1 ({T})")
        bits = _viterbi(
            jnp.asarray(levels),
            jnp.asarray(self._expected),
            jnp.asarray(self._prev0),
            jnp.asarray(self._prev1),
        )
        return np.asarray(bits[:msg_len], dtype=np.uint8)

    def decode_bits(self, bits, msg_len: int):
        """Hard-decision decode; returns (data bits [msg_len], False)."""
        levels = np.asarray(bits, dtype=np.float32)
        return self.decode_soft(levels, msg_len), False


@partial(jax.jit, static_argnames=())
def _viterbi(levels, expected, prev0, prev1):
    """All-states add-compare-select scan + traceback.

    levels   [T, R] soft received levels
    expected [S, 2, R] expected output bits per (prev state, input)
    prev0/1  [S] predecessor states of each next-state
    """
    S = expected.shape[0]
    in_bit = jnp.arange(S, dtype=jnp.int32) & 1
    big = jnp.float32(1e9)
    m0 = jnp.full((S,), big, dtype=jnp.float32).at[0].set(0.0)

    def step(m, r):
        # branch metric per (prev state, input): L1 distance to expected
        bm = jnp.abs(r[None, None, :] - expected).sum(axis=-1)  # [S, 2]
        cand0 = m[prev0] + bm[prev0, in_bit]
        cand1 = m[prev1] + bm[prev1, in_bit]
        take1 = cand1 < cand0
        new_m = jnp.where(take1, cand1, cand0)
        new_m = new_m - new_m.min()  # renormalize to avoid drift
        return new_m, take1

    from ..utils.planar import planar_scan

    _, decisions = planar_scan(step, m0, levels)  # decisions [T, S] bool

    def back(s, take1_t):
        bit = s & 1
        p = jnp.where(take1_t[s], prev1[s], prev0[s])
        return p, bit

    _, bits_rev = planar_scan(back, jnp.int32(0), decisions, reverse=True)
    return bits_rev  # [T] (time-ordered because reverse scan stacks in order)


class PuncturedConvCode:
    """Punctured rate-p/(p+1) code over a rate-1/2 mother code.

    Puncture pattern: period p, output A always kept, output B kept only on
    phase 0 — keeping p+1 of every 2p mother bits (self-consistent
    encoder/decoder pair; punctured positions are restored as 0.5-erasures
    before Viterbi, exactly the ka9q depuncture strategy).
    """

    def __init__(self, base: ConvCode, p: int, name: str):
        if base.R != 2:
            raise ConfigError("puncturing requires a rate-1/2 mother code")
        if p < 2 or p > 7:
            raise ConfigError(f"puncture period p ({p}) must be in [2,7]")
        self.base = base
        self.p = p
        self.K = base.K
        self.name = name
        self.rate = p / (p + 1.0)
        keep = np.ones((p, 2), dtype=bool)
        keep[1:, 1] = False  # drop B except on phase 0
        self._keep = keep

    def _mask(self, T: int) -> np.ndarray:
        reps = -(-T // self.p)
        return np.tile(self._keep, (reps, 1))[:T]  # [T, 2]

    def encode_bits(self, bits) -> np.ndarray:
        full = self.base.encode_bits(bits).reshape(-1, 2)
        mask = self._mask(full.shape[0])
        return full[mask]

    def decode_soft(self, levels, msg_len: int) -> np.ndarray:
        T = msg_len + self.K - 1
        mask = self._mask(T)
        grid = np.full((T, 2), 0.5, dtype=np.float32)
        levels = np.asarray(levels, dtype=np.float32).ravel()
        if levels.shape[0] != int(mask.sum()):
            raise ConfigError(
                f"received length {levels.shape[0]} != {int(mask.sum())}")
        grid[mask] = levels
        return self.base.decode_soft(grid.reshape(-1), msg_len)

    def decode_bits(self, bits, msg_len: int):
        return self.decode_soft(np.asarray(bits, np.float32), msg_len), False


def conv27() -> ConvCode:
    return ConvCode(7, _V27_POLYS, "conv27")


def conv29() -> ConvCode:
    return ConvCode(9, _V29_POLYS, "conv29")


def conv39() -> ConvCode:
    return ConvCode(9, _V39_POLYS, "conv39")


def conv615() -> ConvCode:
    return ConvCode(15, _V615_POLYS, "conv615")


def conv_punctured(base_name: str, p: int) -> PuncturedConvCode:
    """liquid conv27p23..conv29p78 family: base in {conv27, conv29},
    rate p/(p+1)."""
    base = {"conv27": conv27, "conv29": conv29}.get(base_name)
    if base is None:
        raise ConfigError(f"unknown punctured base {base_name!r}")
    return PuncturedConvCode(base(), p, f"{base_name}p{p}{p + 1}")
