"""OFDM frame generator + synchronizer.

No yagi implementation exists (src/multichannel/mod.rs is an empty stub);
behavioral spec is liquid-dsp's ofdmframegen/ofdmframesync
(LIQUID_COMPAT.md:1801-1810): M subcarriers typed {null, pilot, data},
cyclic prefix, an S0 short-sync symbol (periodic halves -> Schmidl-Cox
timing metric + fractional CFO) and an S1 long-sync symbol (cross
correlation -> channel estimate), then data symbols with per-symbol pilot
phase tracking and one-tap frequency-domain equalization.

Block-parallel: generation and demodulation treat the whole frame as a
``[num_symbols, M]`` batch — one batched (I)FFT, one vectorized equalizer
multiply, and a closed-form LSQ pilot phase fit per symbol (vectorized
across symbols). No per-sample loops anywhere; only the initial detection
scan is host-orchestrated.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError

__all__ = ["OfdmFrame", "OfdmFrameGen", "OfdmFrameSync",
           "default_sctype"]

NULL, PILOT, DATA = 0, 1, 2


def default_sctype(M: int) -> np.ndarray:
    """Default subcarrier allocation (liquid
    ``ofdmframe_init_default_sctype``): ~6% guard bands each side, DC null,
    pilots every 7th active subcarrier."""
    if M < 8:
        raise ConfigError(f"number of subcarriers M ({M}) must be >= 8")
    p = np.full(M, DATA, dtype=np.int32)
    guard = max(1, M // 16)
    # FFT-ordered: index 0 = DC, 1..M/2 positive, M/2..M-1 negative
    p[0] = NULL
    p[M // 2 - guard: M // 2 + guard + 1] = NULL
    active = np.nonzero(p == DATA)[0]
    p[active[::7]] = PILOT
    return p


def _validate_sctype(p: np.ndarray):
    n_pilot = int(np.sum(p == PILOT))
    n_data = int(np.sum(p == DATA))
    if n_pilot < 2:
        raise ConfigError(f"subcarrier allocation needs >= 2 pilots "
                          f"(got {n_pilot})")
    if n_data < 1:
        raise ConfigError("subcarrier allocation needs >= 1 data subcarrier")


def _pn_sequence(n: int, seed: int) -> np.ndarray:
    """Deterministic +/-1 sequence for sync symbols and pilots."""
    rng = np.random.default_rng(seed)
    return (1.0 - 2.0 * rng.integers(0, 2, n)).astype(np.float64)


class OfdmFrame:
    """Shared frame geometry: subcarrier map, sync symbols, pilots."""

    def __init__(self, M: int = 64, cp_len: int = 16, sctype=None):
        if M < 8:
            raise ConfigError(f"number of subcarriers M ({M}) must be >= 8")
        if not 0 <= cp_len <= M:
            raise ConfigError(f"cyclic prefix length ({cp_len}) not in [0,M]")
        self.M = M
        self.cp_len = cp_len
        self.p = np.asarray(sctype, dtype=np.int32) if sctype is not None \
            else default_sctype(M)
        if self.p.size != M:
            raise ConfigError(
                f"subcarrier map length {self.p.size} != M ({M})")
        _validate_sctype(self.p)
        self.i_pilot = np.nonzero(self.p == PILOT)[0]
        self.i_data = np.nonzero(self.p == DATA)[0]
        self.n_data = self.i_data.size
        # S0: energy only on even active subcarriers -> periodic in time
        # with period M/2 (Schmidl-Cox structure)
        s0f = np.zeros(M, dtype=np.complex128)
        act = np.nonzero(self.p != NULL)[0]
        act_even = act[act % 2 == 0]
        s0f[act_even] = _pn_sequence(act_even.size, seed=11)
        s0f *= np.sqrt(2.0)  # unit average power in time
        self.S0f = s0f
        self.s0t = np.fft.ifft(s0f) * np.sqrt(M)
        # S1: all active subcarriers
        s1f = np.zeros(M, dtype=np.complex128)
        s1f[act] = _pn_sequence(act.size, seed=13)
        self.S1f = s1f
        self.s1t = np.fft.ifft(s1f) * np.sqrt(M)
        # pilot base values
        self.pilots = _pn_sequence(self.i_pilot.size, seed=17)
        self.sym_len = M + cp_len

    def _add_cp(self, x: np.ndarray) -> np.ndarray:
        return np.concatenate([x[..., -self.cp_len:], x], axis=-1) \
            if self.cp_len else x


class OfdmFrameGen(OfdmFrame):
    """OFDM frame generator (liquid ``ofdmframegen``)."""

    def write_preamble(self) -> np.ndarray:
        """Two S0 symbols + one S1 symbol, each with CP."""
        return np.concatenate([
            self._add_cp(self.s0t), self._add_cp(self.s0t),
            self._add_cp(self.s1t),
        ]).astype(np.complex64)

    def write_symbols(self, data_symbols) -> np.ndarray:
        """Map data subcarrier values [num_syms, n_data] -> time samples
        [num_syms * (M+cp)]; pilots and nulls inserted automatically.
        One batched IFFT."""
        data_symbols = np.atleast_2d(np.asarray(data_symbols,
                                                dtype=np.complex128))
        if data_symbols.shape[-1] != self.n_data:
            raise ConfigError(
                f"data width {data_symbols.shape[-1]} != number of data "
                f"subcarriers ({self.n_data})")
        ns = data_symbols.shape[0]
        X = np.zeros((ns, self.M), dtype=np.complex128)
        X[:, self.i_data] = data_symbols
        X[:, self.i_pilot] = self.pilots[None, :]
        x = np.fft.ifft(X, axis=-1) * np.sqrt(self.M)
        return self._add_cp(x).reshape(-1).astype(np.complex64)

    def assemble(self, data_symbols) -> np.ndarray:
        """Full frame: preamble + payload symbols."""
        return np.concatenate([self.write_preamble(),
                               self.write_symbols(data_symbols)])


class OfdmFrameSync(OfdmFrame):
    """OFDM frame synchronizer (liquid ``ofdmframesync``).

    ``execute(x, num_symbols)`` returns None (no detection) or a dict:
    ``symbols`` [num_symbols, n_data] equalized data subcarriers,
    ``stats`` {tau, cfo, rssi_db, evm_pilots_db}.
    """

    def __init__(self, M: int = 64, cp_len: int = 16, sctype=None,
                 threshold: float = 0.6):
        super().__init__(M, cp_len, sctype)
        if not 0.0 < threshold < 1.0:
            raise ConfigError(f"threshold ({threshold}) must be in (0,1)")
        self.threshold = threshold

    def execute(self, x, num_symbols: int):
        x = np.asarray(x, dtype=np.complex128).ravel()
        M, cp, half = self.M, self.cp_len, self.M // 2
        need = 3 * self.sym_len + num_symbols * self.sym_len
        if x.size < need:
            raise ConfigError(f"buffer ({x.size}) shorter than frame ({need})")
        # --- Schmidl-Cox metric over the S0 region (vectorized) ---
        c = x[:-half] * np.conj(x[half:])
        kern = np.ones(half)
        P = np.convolve(c, kern, mode="valid")           # corr of halves
        E = np.convolve(np.abs(x) ** 2, kern, mode="valid")
        R = np.abs(P[: E.size - half]) / (
            0.5 * (E[:-half] + E[half:]) + 1e-20)
        cand = np.nonzero(R > self.threshold)[0]
        if cand.size == 0:
            return None
        # plateau center: first run of above-threshold samples
        run_end = cand[0]
        while run_end + 1 in set(cand.tolist()):
            run_end += 1
        # fractional CFO from the repetition phase
        # (use the best metric point in the run)
        run = cand[(cand >= cand[0]) & (cand <= run_end)]
        d0 = int(run[np.argmax(R[run])])
        cfo = float(np.angle(P[d0]) / half)  # rad/sample (conj order: -phi)
        cfo = -cfo
        n = np.arange(x.size)
        y = x * np.exp(-1j * cfo * n)
        # --- fine timing: cross-correlate with known s1t near the coarse
        # position (S1 follows two S0 symbols) ---
        approx = d0 + 2 * self.sym_len + cp  # rough S1 body start
        lo = max(0, approx - self.sym_len)
        hi = min(y.size - M, approx + self.sym_len)
        seg = y[lo: hi + M]
        corr = np.correlate(seg, self.s1t, mode="valid")
        pk = int(np.argmax(np.abs(corr)))
        s1_start = lo + pk
        rxy = np.abs(corr[pk]) / (
            np.sqrt(np.sum(np.abs(self.s1t) ** 2)
                    * np.sum(np.abs(y[s1_start: s1_start + M]) ** 2)) + 1e-20)
        if rxy < self.threshold:
            return None
        # --- channel estimate from S1 ---
        Y1 = np.fft.fft(y[s1_start: s1_start + M]) / np.sqrt(M)
        act = self.p != NULL
        G = np.ones(M, dtype=np.complex128)
        G[act] = Y1[act] / self.S1f[act]
        # --- payload: one batched FFT over all data symbols ---
        start = s1_start + M  # end of S1 body
        idx = start + cp + (np.arange(num_symbols) * self.sym_len)[:, None] \
            + np.arange(M)[None, :]
        if idx[-1, -1] >= y.size:
            return None
        blocks = y[idx]                                   # [ns, M]
        Yd = np.fft.fft(blocks, axis=-1) / np.sqrt(M)
        Zd = Yd / (G[None, :] + 1e-12)
        # --- pilot phase tracking: LSQ linear fit across pilot subcarriers
        # per symbol (residual timing slope + common phase) ---
        prx = Zd[:, self.i_pilot] * self.pilots[None, :]  # expected real +
        k_p = self.i_pilot.astype(np.float64)
        k_p = np.where(k_p > M / 2, k_p - M, k_p)         # centered index
        ang = np.angle(prx)                               # [ns, n_pilot]
        w = np.abs(prx)
        W = w.sum(axis=1)
        Sk = (w * k_p).sum(axis=1)
        Skk = (w * k_p * k_p).sum(axis=1)
        Sa = (w * ang).sum(axis=1)
        Ska = (w * k_p * ang).sum(axis=1)
        det = Skk * W - Sk * Sk
        slope = np.where(np.abs(det) > 1e-12, (Ska * W - Sk * Sa) / det, 0.0)
        const = np.where(W > 1e-12, (Sa - slope * Sk) / np.maximum(W, 1e-12),
                         0.0)
        k_d = self.i_data.astype(np.float64)
        k_d = np.where(k_d > M / 2, k_d - M, k_d)
        corr_ph = np.exp(-1j * (const[:, None] + slope[:, None] * k_d[None, :]))
        symbols = (Zd[:, self.i_data] * corr_ph).astype(np.complex64)
        # pilot EVM after correction
        pcorr = np.exp(-1j * (const[:, None] + slope[:, None] * k_p[None, :]))
        perr = Zd[:, self.i_pilot] * pcorr - self.pilots[None, :]
        evm = 10.0 * np.log10(np.mean(np.abs(perr) ** 2) + 1e-20)
        rssi = 10.0 * np.log10(np.mean(np.abs(blocks) ** 2) + 1e-20)
        return {
            "symbols": symbols,
            "stats": {
                "tau": float(s1_start - 2 * self.sym_len - cp),
                "cfo": cfo,
                "rssi_db": float(rssi),
                "evm_pilots_db": float(evm),
                "rxy": float(rxy),
            },
        }
