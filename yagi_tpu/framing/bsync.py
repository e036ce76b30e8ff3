"""BSync: binary (hard-limited) correlator synchronizer.

Behavioral spec: liquid-dsp's ``bsync_rrrf``/``bsync_crcf`` (LIQUID_COMPAT.md
"bsync" rows — the reference never ported it). The synchronizer hard-limits
the incoming stream to sign bits and correlates them against a known binary
sequence; the output ``rxy`` is the normalized bit-agreement in [-1, 1]
(complex for crcf: I and Q limbs correlated independently). Because only
signs enter the correlation, the detector is immune to amplitude fading and
costs one ±1 dot product per lag.

Block-parallel: a block of samples is processed as one XLA convolution of the
sign stream with the ±1 template — [..., N] in, [..., N] rxy out — with an
explicit carry of the last n-1 signs so block boundaries are seamless
(split-invariant, like every streaming op in this framework).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..errors import ConfigError

__all__ = ["BSync"]


@partial(jax.jit, static_argnames=("n",))
def _corr_block(signs, carry, template, n):
    """Correlate sign stream against ±1 template.

    signs    [..., N]   ±1 (float32) hard-limited input
    carry    [..., n-1] previous block's trailing signs
    template [n]        ±1, index 0 = oldest
    returns (rxy [..., N], new_carry [..., n-1])
    """
    full = jnp.concatenate([carry, signs], axis=-1)
    # rxy[k] = (1/n) sum_i template[i] * full[k + i]
    kernel = template[::-1]
    rxy = jax.vmap(lambda row: jnp.convolve(row, kernel, mode="valid"))(
        full.reshape((-1, full.shape[-1]))
    ).reshape(signs.shape) / n
    new_carry = full[..., full.shape[-1] - (n - 1):]
    return rxy, new_carry


class BSync:
    """Binary correlator over a ±1 sequence.

    ``execute_block(x, state)`` returns per-sample normalized correlation
    ``rxy`` (same shape as ``x``; complex input → complex rxy with I/Q
    correlated independently) plus the updated carry state. ``rxy[k]`` is
    the correlation of the window *ending* at sample k, matching the
    streaming one-sample-at-a-time semantics of liquid's ``bsync_execute``.
    """

    def __init__(self, sequence):
        seq = np.asarray(sequence, dtype=np.float32).ravel()
        if seq.size == 0:
            raise ConfigError("sequence length must be > 0")
        self.n = int(seq.size)
        self._template = jnp.asarray(np.sign(seq) + (seq == 0), jnp.float32)

    @classmethod
    def from_msequence(cls, ms) -> "BSync":
        """Template from an m-sequence (bits 0/1 → ∓1)."""
        bits = ms.generate_bits(ms.get_length())
        return cls(2.0 * np.asarray(bits, np.float32) - 1.0)

    def execute_block(self, x, state=None):
        x = jnp.asarray(x)
        if jnp.iscomplexobj(x):
            xi, xq = jnp.real(x), jnp.imag(x)
            si = jnp.sign(xi) + (xi == 0)
            sq = jnp.sign(xq) + (xq == 0)
            if state is None:
                z = jnp.zeros(x.shape[:-1] + (self.n - 1,), jnp.float32)
                state = (z, z)
            ri, ci = _corr_block(si.astype(jnp.float32), state[0],
                                 self._template, self.n)
            rq, cq = _corr_block(sq.astype(jnp.float32), state[1],
                                 self._template, self.n)
            return ri + 1j * rq, (ci, cq)
        signs = (jnp.sign(x) + (x == 0)).astype(jnp.float32)
        if state is None:
            state = jnp.zeros(x.shape[:-1] + (self.n - 1,), jnp.float32)
        return _corr_block(signs, state, self._template, self.n)
