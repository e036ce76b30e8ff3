"""Streaming spectral periodogram (batched formulation).

Behavioral spec: /root/reference/src/fft/spgram.rs. The reference pushes one
sample at a time into a sliding window and runs one FFT every ``delay``
samples (spgram.rs:237-288). Here a whole block is processed at once: all
frame positions inside the block are gathered into a [frames, nfft] matrix and
transformed with ONE batched FFT, and the PSD accumulation
recurrence is applied in closed form:

  accumulate mode (alpha = -1): psd += Σ |F_t|²           (plain sum)
  exponential mode:             psd' = γ^k psd + α Σ γ^{k-1-t} |F_t|²

which is exactly the per-transform recurrence psd = γ·psd + α·|F|²
(spgram.rs:276-283) unrolled — bit-for-block equal to sequential streaming.

Note: the reference's ``get_psd_mag`` scales by 0 in exponential mode
(spgram.rs:295-299), an apparent porting bug (liquid uses 1.0); we use 1.0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._src import struct
from ..errors import ConfigError
from ..math import windows as mwin
from ..math.windows import WindowType

SPGRAM_PSD_MIN = 1e-12  # spgram.rs:11


def _design_window(wtype: WindowType, window_len: int) -> np.ndarray:
    """Window + energy normalization g = 1/sqrt(Σ w²) (spgram.rs:92-118)."""
    beta = 10.0
    zeta = 3.0
    if wtype == WindowType.KAISER:
        w = mwin.kaiser(window_len, beta)
    elif wtype == WindowType.TRIANGULAR:
        w = mwin.triangular(window_len, window_len)
    elif wtype == WindowType.RCOS_TAPER:
        w = mwin.rcos_taper(window_len, window_len // 3)
    elif wtype == WindowType.KBD:
        w = mwin.kbd_window(window_len, zeta)
    else:
        w = mwin.window(wtype, window_len)
    g = 1.0 / np.sqrt(np.sum(w * w))
    return (g * w).astype(np.float32)


@struct.pytree
class Spgram:
    """Streaming spectral periodogram state (pytree).

    Matches reference struct fields (spgram.rs:14-41); ``buffer`` carries the
    last ``window_len`` input samples (oldest..newest), the rest is counters.
    """

    # static configuration
    nfft: int = struct.static_field()
    window_len: int = struct.static_field()
    delay: int = struct.static_field()
    wtype: WindowType = struct.static_field()
    alpha: float = struct.static_field()
    gamma: float = struct.static_field()
    accumulate: bool = struct.static_field()

    # arrays
    w: jnp.ndarray = struct.field()  # [window_len] normalized window
    buffer: jnp.ndarray = struct.field()  # [window_len] sample history
    psd: jnp.ndarray = struct.field()  # [nfft] accumulated |F|^2

    # counters (traced scalars)
    sample_timer: jnp.ndarray = struct.field()
    num_samples: jnp.ndarray = struct.field()
    num_samples_total: jnp.ndarray = struct.field()
    num_transforms: jnp.ndarray = struct.field()
    num_transforms_total: jnp.ndarray = struct.field()

    # ------------------------------------------------------------------ ctor
    @classmethod
    def create(
        cls,
        nfft: int,
        wtype: WindowType = WindowType.KAISER,
        window_len: int | None = None,
        delay: int | None = None,
        alpha: float = -1.0,
        dtype=jnp.complex64,
    ) -> "Spgram":
        """Create spgram (spgram.rs:49-123); defaults per spgram.rs:126-132."""
        if window_len is None:
            window_len = nfft // 2
        if delay is None:
            delay = nfft // 4
        if nfft < 2:
            raise ConfigError("fft size must be at least 2")
        if window_len > nfft:
            raise ConfigError("window size cannot exceed fft size")
        if window_len == 0:
            raise ConfigError("window size must be greater than zero")
        if wtype in (WindowType.KAISER, WindowType.KBD) and window_len % 2 != 0:
            # reference enforces even length for its Kaiser/KBD path
            raise ConfigError("window length must be even for Kaiser/KBD window")
        if delay == 0:
            raise ConfigError("delay must be greater than 0")
        if alpha != -1.0 and not (0.0 <= alpha <= 1.0):
            raise ConfigError("alpha must be -1 or in [0,1]")

        accumulate = alpha == -1.0
        a = 1.0 if accumulate else alpha
        g = 1.0 if accumulate else 1.0 - alpha

        w = _design_window(wtype, window_len)
        return cls(
            nfft=nfft,
            window_len=window_len,
            delay=delay,
            wtype=wtype,
            alpha=float(a),
            gamma=float(g),
            accumulate=accumulate,
            w=jnp.asarray(w),
            buffer=jnp.zeros(window_len, dtype=dtype),
            psd=jnp.zeros(nfft, dtype=jnp.float32),
            sample_timer=jnp.asarray(delay, dtype=jnp.int32),
            num_samples=jnp.asarray(0, dtype=jnp.int32),
            num_samples_total=jnp.asarray(0, dtype=jnp.int32),
            num_transforms=jnp.asarray(0, dtype=jnp.int32),
            num_transforms_total=jnp.asarray(0, dtype=jnp.int32),
        )

    # ------------------------------------------------------------- streaming
    def write(self, x) -> "Spgram":
        """Process a block of samples; returns updated state (spgram.rs:254).

        The number of transforms inside the block is data-dependent on the
        carried ``sample_timer``; a static capacity of ceil(N/delay)+1 frames
        is computed and invalid frames masked, keeping the method jittable.
        """
        x = jnp.asarray(x)
        n = x.shape[0]
        wl = self.window_len
        xa = jnp.concatenate([self.buffer, x.astype(self.buffer.dtype)])

        # Transform t fires after consuming local sample index
        # i_t = (sample_timer - 1) + t*delay  for i_t < n.
        max_frames = n // self.delay + 1
        t_idx = jnp.arange(max_frames)
        fire_at = (self.sample_timer - 1) + t_idx * self.delay
        valid = fire_at < n
        k = jnp.sum(valid.astype(jnp.int32))  # transforms this block

        # Gather frames: frame t covers xa[fire_at+1 : fire_at+1+wl]
        start = jnp.clip(fire_at + 1, 0, n)  # invalid frames clamped
        gather_idx = start[:, None] + jnp.arange(wl)[None, :]
        frames = xa[gather_idx]  # [max_frames, wl]

        # Window, zero-pad to nfft, batched FFT, |.|^2
        buf_time = frames * self.w[None, :].astype(frames.dtype)
        if self.nfft > wl:
            pad = jnp.zeros((max_frames, self.nfft - wl), dtype=buf_time.dtype)
            buf_time = jnp.concatenate([buf_time, pad], axis=1)
        F = jnp.fft.fft(buf_time, axis=1)
        mag_sq = (F * jnp.conj(F)).real.astype(jnp.float32)
        mag_sq = jnp.where(valid[:, None], mag_sq, 0.0)

        if self.accumulate:
            new_psd = self.psd + jnp.sum(mag_sq, axis=0)
        else:
            # closed-form exponential recurrence over the k valid frames,
            # honoring the first-transform override (spgram.rs:278-282)
            gamma = jnp.float32(self.gamma)
            alpha = jnp.float32(self.alpha)
            # rank of each valid frame among valid frames (0-based)
            rank = jnp.cumsum(valid.astype(jnp.int32)) - 1
            weight = jnp.where(valid, alpha * gamma ** (k - 1 - rank), 0.0)
            first_global = self.num_transforms == 0
            # if the very first transform ever lands in this block, its term
            # uses weight gamma^(k-1) (psd set, then decayed k-1 times)
            weight = jnp.where(
                first_global & (rank == 0) & valid,
                gamma ** (k - 1 - rank),
                weight,
            )
            decay = jnp.where(first_global & (k > 0), 0.0, gamma**k)
            new_psd = decay * self.psd + jnp.sum(weight[:, None] * mag_sq, axis=0)

        new_buffer = xa[xa.shape[0] - wl :]
        # timer: remaining countdown after the block
        consumed_since_fire = jnp.where(
            k > 0, n - 1 - (self.sample_timer - 1 + (k - 1) * self.delay), -1
        )
        new_timer = jnp.where(
            k > 0, self.delay - consumed_since_fire, self.sample_timer - n
        ).astype(jnp.int32)

        return self.replace(
            buffer=new_buffer,
            psd=new_psd,
            sample_timer=new_timer,
            num_samples=self.num_samples + n,
            num_samples_total=self.num_samples_total + n,
            num_transforms=self.num_transforms + k,
            num_transforms_total=self.num_transforms_total + k,
        )

    push = write  # single samples are just length-1 blocks

    def step(self) -> "Spgram":
        """Force one transform from current buffer contents (spgram.rs:261)."""
        frame = self.buffer * self.w.astype(self.buffer.dtype)
        buf_time = jnp.zeros(self.nfft, dtype=frame.dtype).at[: self.window_len].set(frame)
        F = jnp.fft.fft(buf_time)
        mag_sq = (F * jnp.conj(F)).real.astype(jnp.float32)
        if self.accumulate:
            new_psd = self.psd + mag_sq
        else:
            new_psd = jnp.where(
                self.num_transforms == 0,
                mag_sq,
                self.gamma * self.psd + self.alpha * mag_sq,
            )
        return self.replace(
            psd=new_psd,
            num_transforms=self.num_transforms + 1,
            num_transforms_total=self.num_transforms_total + 1,
        )

    # ------------------------------------------------------------- accessors
    def get_nfft(self) -> int:
        return self.nfft

    def get_window_len(self) -> int:
        return self.window_len

    def get_delay(self) -> int:
        return self.delay

    def get_alpha(self) -> float:
        """Smoothing factor; -1 in accumulate mode (spgram.rs get_alpha)."""
        return -1.0 if self.accumulate else self.alpha

    def set_alpha(self, alpha: float) -> "Spgram":
        """Switch accumulate (-1) / exponential smoothing (spgram.rs:158-183)."""
        if alpha != -1.0 and not (0.0 <= alpha <= 1.0):
            raise ConfigError("alpha must be -1 or in [0,1]")
        accumulate = alpha == -1.0
        return self.replace(
            accumulate=accumulate,
            alpha=1.0 if accumulate else float(alpha),
            gamma=1.0 if accumulate else 1.0 - float(alpha),
        )

    def set_rate(self, rate: float) -> "Spgram":
        """Display sample rate; must be positive (spgram.rs set_rate)."""
        if rate <= 0.0:
            raise ConfigError("sample rate must be greater than zero")
        return self  # display-only in the reference; no state to carry

    # --------------------------------------------------------------- output
    def get_psd_mag(self):
        """FFT-shifted linear PSD (spgram.rs:292-305)."""
        scale = jnp.where(
            self.accumulate,
            1.0 / jnp.maximum(1, self.num_transforms).astype(jnp.float32),
            jnp.float32(1.0),  # reference has 0.0 here — porting bug, see module docstring
        )
        shifted = jnp.roll(self.psd, self.nfft // 2)
        return jnp.maximum(shifted, SPGRAM_PSD_MIN) * scale

    def get_psd(self):
        """FFT-shifted PSD in dB (spgram.rs:309-316)."""
        return 10.0 * jnp.log10(self.get_psd_mag())

    def export_gnuplot(self, path: str) -> None:
        """Write a standalone gnuplot script of the current PSD
        (liquid ``spgram_export_gnuplot``; spgram_gnuplot autotest)."""
        import numpy as _np
        psd = _np.asarray(self.get_psd())
        f = _np.arange(self.nfft) / self.nfft - 0.5
        with open(path, "w") as fh:
            fh.write("# %s: auto-generated by yagi_tpu Spgram\n" % path)
            fh.write("reset\n")
            fh.write("set terminal png size 800,600\n")
            fh.write("set xrange [-0.5:0.5]\n")
            fh.write("set xlabel 'Normalized Frequency [f/Fs]'\n")
            fh.write("set ylabel 'PSD [dB]'\n")
            fh.write("set grid\n")
            fh.write("plot '-' w lines lw 2 notitle\n")
            for fi, pi in zip(f, psd):
                fh.write("%12.8f %12.6f\n" % (fi, pi))
            fh.write("e\n")

    def clear(self) -> "Spgram":
        """Reset accumulation but keep the sample buffer (spgram.rs:136)."""
        return self.replace(
            psd=jnp.zeros_like(self.psd),
            sample_timer=jnp.asarray(self.delay, dtype=jnp.int32),
            num_samples=jnp.zeros_like(self.num_samples),
            num_transforms=jnp.zeros_like(self.num_transforms),
        )

    def reset(self) -> "Spgram":
        """Full reset (spgram.rs:151)."""
        return self.clear().replace(
            buffer=jnp.zeros_like(self.buffer),
            num_samples_total=jnp.zeros_like(self.num_samples_total),
            num_transforms_total=jnp.zeros_like(self.num_transforms_total),
        )


def spgram_estimate_psd(nfft: int, x, wtype: WindowType = WindowType.KAISER):
    """One-shot PSD estimate (spgram.rs:319-329)."""
    x = jnp.asarray(x)
    sp = Spgram.create(nfft, wtype=wtype, dtype=x.dtype)
    sp = sp.write(x)
    sp = jax.lax.cond(
        sp.num_transforms == 0, lambda s: s.step(), lambda s: s, sp
    )
    return sp.get_psd()
