"""Symbol stream generators.

Behavioral specs:
* SymStream — /root/reference/src/framing/symstream.rs: random symbols from
  an m-sequence → Modem.modulate → ×gain → 1:k interpolation
  (symstream.rs:104-121). The block form generates a whole block of symbols at
  once (LFSR host-side, exact) and interpolates in one batched call; a carry
  buffer preserves arbitrary block lengths.
* SymStreamR — symstreamr.rs: SymStream at 2 samples/symbol followed by an
  arbitrary-rate MsResamp (host-orchestrated like MsResamp itself).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..errors import ConfigError
from ..design import FirFilterShape
from ..filter import FirInterpolationFilter, MsResamp
from ..modem import Modem, ModulationScheme
from ..sequence import MSequence

__all__ = ["SymStream", "SymStreamR"]


class SymStream:
    """Symbol stream generator (symstream.rs:7-17).

    Host-orchestrated: symbol randomness comes from an exact m-sequence
    (modem.rs:238), per-block sample counts are static.
    """

    def __init__(
        self,
        ftype: FirFilterShape = FirFilterShape.ARKAISER,
        k: int = 2,
        m: int = 7,
        beta: float = 0.3,
        scheme="qpsk",
    ):
        if k < 2:
            raise ConfigError("samples/symbol must be at least 2")
        if m == 0:
            raise ConfigError("filter delay must be greater than zero")
        if not 0.0 <= beta <= 1.0:
            raise ConfigError("filter excess bandwidth must be in (0,1]")
        self.ftype = ftype
        self.k = k
        self.m = m
        self.beta = beta
        self.modem = Modem.create(scheme)
        # m=11 randomizer (period 2047) per the reference's modem randomizer
        # (modem.rs:446); a shorter sequence's line spectrum notches the
        # signal PSD (visible as a ~3.6 dB DC dip at m=7)
        self.msequence = MSequence.create_default(11)
        self.gain = 1.0
        self.interp = FirInterpolationFilter.create_prototype(
            ftype, k, m, beta, 0.0, dtype=jnp.complex64
        )
        self._carry = np.zeros(0, dtype=np.complex64)

    # ------------------------------------------------------------ properties
    def get_ftype(self):
        return self.ftype

    def get_k(self):
        return self.k

    def get_m(self):
        return self.m

    def get_beta(self):
        return self.beta

    def get_scheme(self):
        return self.modem.get_scheme()

    def set_scheme(self, scheme) -> None:
        self.modem = Modem.create(scheme)

    def set_gain(self, gain: float) -> None:
        self.gain = gain

    def get_gain(self) -> float:
        return self.gain

    def get_delay(self) -> int:
        """k·m samples (symstream.rs:100-102)."""
        return self.k * self.m

    def reset(self) -> None:
        self.modem = self.modem.reset()
        self.interp = self.interp.reset()
        self.msequence.reset()
        self._carry = np.zeros(0, dtype=np.complex64)

    # -------------------------------------------------------------- generate
    def write_samples(self, num_samples: int) -> np.ndarray:
        """Generate num_samples samples (symstream.rs:111-121)."""
        need = num_samples - len(self._carry)
        if need > 0:
            n_sym = -(-need // self.k)
            syms = self.msequence.generate_symbols(
                self.modem.bits_per_symbol, n_sym
            )
            v, self.modem = self.modem.modulate(jnp.asarray(syms))
            v = jnp.asarray(v) * jnp.float32(self.gain)
            block, self.interp = self.interp.execute_block(v)
            self._carry = np.concatenate([self._carry, np.asarray(block)])
        out = self._carry[:num_samples]
        self._carry = self._carry[num_samples:]
        return out


class SymStreamR:
    """Arbitrary-rate symbol stream = SymStream + MsResamp (symstreamr.rs:10-16)."""

    def __init__(
        self,
        ftype: FirFilterShape = FirFilterShape.ARKAISER,
        bw: float = 0.5,
        m: int = 7,
        beta: float = 0.3,
        scheme="qpsk",
    ):
        if bw <= 0.0 or bw > 1.0:
            raise ConfigError("bandwidth must be in (0,1)")
        self.bw = bw
        # internal symstream at k=2 samples/symbol, resampled by 0.5/bw
        # (symstreamr.rs:36-38); get_bw = 1/(rate·k)
        self.symstream = SymStream(ftype, 2, m, beta, scheme)
        self.resamp = MsResamp.create(0.5 / bw, 60.0)
        self._carry = np.zeros(0, dtype=np.complex64)

    def get_bw(self) -> float:
        return self.bw

    def get_ftype(self):
        return self.symstream.get_ftype()

    def get_m(self):
        return self.symstream.get_m()

    def get_beta(self):
        return self.symstream.get_beta()

    def get_scheme(self):
        return self.symstream.get_scheme()

    def set_scheme(self, scheme) -> None:
        self.symstream.set_scheme(scheme)

    def set_gain(self, gain: float) -> None:
        self.symstream.set_gain(gain)

    def get_gain(self) -> float:
        return self.symstream.get_gain()

    def get_bw_actual(self) -> float:
        return 1.0 / (self.resamp.get_rate() * self.symstream.get_k())

    def get_delay(self) -> float:
        """(p + d)·r (symstreamr.rs:94-99)."""
        p = float(self.symstream.get_delay())
        d = float(self.resamp.get_delay())
        r = float(self.resamp.get_rate())
        return (p + d) * r

    def reset(self) -> None:
        self.symstream.reset()
        self.resamp = self.resamp.reset()
        self._carry = np.zeros(0, dtype=np.complex64)

    def write_samples(self, num_samples: int) -> np.ndarray:
        """Generate num_samples samples (symstreamr.rs:118ff).

        Generated in power-of-two input chunks sized to the request (few jit
        specializations, one resampler call per chunk) rather than the
        reference's fixed tiny buffer loop.
        """
        parts = [self._carry]
        have = len(self._carry)
        rate = float(self.resamp.get_rate())
        while have < num_samples:
            # size the input chunk to the remaining request: large requests
            # amortize (few jit shapes), small requests stay input-sample
            # granular so set_gain takes effect within ~1 input sample of
            # carried lookahead — the reference's buffer holds at most one
            # input sample's worth of resampler output (symstreamr.rs:40-48)
            need_in = max(1, int(np.ceil((num_samples - have) / max(rate, 1e-6))))
            chunk_in = 1
            while chunk_in < need_in and chunk_in < (1 << 16):
                chunk_in *= 2
            x = self.symstream.write_samples(chunk_in)
            y, self.resamp = self.resamp.execute(jnp.asarray(x))
            y = np.asarray(y).ravel()
            parts.append(y)
            have += len(y)
        self._carry = np.concatenate(parts) if len(parts) > 1 else parts[0]
        out = self._carry[:num_samples]
        self._carry = self._carry[num_samples:]
        return out
