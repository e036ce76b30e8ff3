"""Gather-free arbitrary-rate fast path: prototype FIR + designed Farrow.

The reference's arbitrary resampler (resamp.rs:141-154) evaluates the
continuous prototype filter h at fractional positions via a 256-branch
polyphase bank: y_m = (h ⊛ x)(τ_m), with τ_m the exact u32 emission times
(τ advances by step = round(2^24/rate) per output, 2^24 per input) and the
fractional part of τ quantized to the nearest of 256 branch offsets.

Block-parallel factorization: (h ⊛ x) is bandlimited by h's own
cutoff, so its integer-grid samples z[i] = Σ_j x[i+j]·h(j·npfb-grid)
(= polyphase branch 0 — one banded-matmul FIR) fully determine the continuous
signal; a POLYNOMIAL fractional interpolator (Farrow structure: K+1 small
FIRs c_k ⊛ z combined as Σ_k μ^k·v_k) evaluates it at the exact fractional
offsets μ_m = (phase_m & 0xffffff)/2^24. The Farrow coefficients are
least-squares designed host-side against e^{-j2πf(μ−d)} over h's passband,
with error below the reference's own 1/256 branch-rounding floor (≈ −45 dB)
— so the fast path is equivalent to the reference within its own
quantization noise, while the emission SCHEDULE (counts, times, carried
phase) stays bit-identical to the u32 gather path.

No traced-index gathers anywhere: the integer parts n_m ride a STATIC grid
ñ_m = (m·step_nom)>>24 plus a small bounded traced offset δ_m selected by
one-hot (δ bounds proven host-side over the full phase range), and the
block-entry offset n₀ = phase>>24 is one dynamic_slice of the input.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_PREC = jax.lax.Precision.HIGHEST

# Select-matmul column layout: "emission" (j-major, dot outputs in output
# order) with automatic fallback to "window" for tiny periods.
_LAYOUT = "emission"

# Farrow design: T taps, polynomial order K, fit band [0, _BAND] cycles/sample
_T = 12
_K = 4
_BAND = 0.33

_design_cache: dict = {}


def farrow_coeffs(T: int = _T, K: int = _K, band: float = _BAND) -> np.ndarray:
    """[K+1, T] polynomial-FIR matrix C: interp(z, i+μ) ≈ Σ_k μ^k (c_k⊛z)[i].

    Least-squares fit of Σ_k μ^k Σ_t c_k[t]·e^{-j2πf(t−d)} to e^{+j2πfμ}
    over f ∈ [0, band], μ ∈ [0, 1), with group delay d = T/2 − 1 + μ
    convention: v_k[i] uses samples z[i−d .. i−d+T−1], so μ ∈ [0,1)
    interpolates between z[i] and z[i+1]. Solved on a dense (f, μ) grid in
    f64; cached per (T, K, band).
    """
    key = (T, K, band)
    if key in _design_cache:
        return _design_cache[key]
    d = T // 2 - 1  # z[i] sits at tap index d when μ=0
    fs = np.linspace(0, band, 96)
    mus = np.linspace(0, 1, 33, endpoint=False)
    t = np.arange(T)
    # basis matrix: rows (f, μ) × columns (k, t)
    rows = []
    rhs = []
    for f in fs:
        e_t = np.exp(2j * np.pi * f * (t - d))  # response of tap t at freq f
        for mu in mus:
            basis = np.concatenate([(mu ** k) * e_t for k in range(K + 1)])
            rows.append(basis)
            rhs.append(np.exp(2j * np.pi * f * mu))
    A = np.asarray(rows)
    b = np.asarray(rhs)
    # real coefficients: stack real/imag parts of the complex LS system
    Ar = np.concatenate([A.real, A.imag])
    br = np.concatenate([b.real, b.imag])
    sol, *_ = np.linalg.lstsq(Ar, br, rcond=None)
    C = sol.reshape(K + 1, T)
    _design_cache[key] = C.astype(np.float64)
    return _design_cache[key]


def farrow_design_error_db(T: int = _T, K: int = _K, band: float = _BAND) -> float:
    """Worst-case interpolation error of the designed Farrow over the band."""
    C = farrow_coeffs(T, K, band)
    d = T // 2 - 1
    t = np.arange(T)
    worst = 0.0
    for f in np.linspace(0, band, 157):
        e_t = np.exp(2j * np.pi * f * (t - d))
        for mu in np.linspace(0, 1, 41, endpoint=False):
            got = sum((mu ** k) * np.dot(C[k], e_t) for k in range(K + 1))
            err = abs(got - np.exp(2j * np.pi * f * mu))
            worst = max(worst, err)
    return 20.0 * np.log10(max(worst, 1e-300))


def periodic_grid(step_nom: int, cap: int):
    """PERIODIC static half-grid ñ_m ≈ (m·step_nom)>>23 + exact δ bounds.

    ñ_m = (m//p̃)·q̃ + pat[m%p̃] with pat[j] = (j·q̃)//p̃ — periodic so the
    v-stream selection compiles to reshapes + ONE static 0/1 matmul
    instead of a gather.
    δ_m = p_m − 2n₀ − ñ_m is bounded over every entry phase by integer
    evaluation at the extreme fractional phases 0 and 2^24−1 (p_m is
    monotone in the phase). q̃ chosen from a small sweep minimizing the
    select-matmul width p̃·D. Returns (q̃, p̃, pat, ñ, d_lo, d_hi).
    """
    import math

    m = np.arange(cap, dtype=np.int64)
    base = m * np.int64(step_nom)
    lo_v = base >> 23
    hi_v = (base + (1 << 24) - 1) >> 23
    # candidate periods: continued-fraction convergents of the exact ratio
    # step/2^23 (z2 positions per output) — convergents keep the grid
    # drift, hence D, small even for "irrational-looking" steps
    num, den = step_nom, 1 << 23
    g = math.gcd(num, den)
    num, den = num // g, den // g
    cands, a, b = [], num, den
    pk_1, pk = 1, 0  # denominators (outputs per period)
    qk_1, qk = 0, 1  # numerators (z2 positions per period)
    while b and pk <= 2048:
        ai = a // b
        a, b = b, a - ai * b
        pk_1, pk = pk, ai * pk + pk_1
        qk_1, qk = qk, ai * qk + qk_1
        if 1 <= pk <= 2048:
            cands.append((pk, qk))
    if not cands:
        cands = [(1, max(1, int(round(step_nom / (1 << 23)))))]
    best = None
    for p2, q2 in cands:
        pat = (np.arange(p2, dtype=np.int64) * q2) // p2
        ntil = (m // p2) * q2 + pat[m % p2]
        d_lo = int((lo_v - ntil).min())
        d_hi = int((hi_v - ntil).max())
        D = d_hi - d_lo + 1
        # select-matmul MACs/input ≈ (band/q̃)·p̃·D, plus the window
        # ASSEMBLY traffic downstream which scales with Wt = T+D−1 per
        # output and dominates the cost — weight D heavily so a deeper
        # convergent with D=4 beats a shorter period with D=7
        band = q2 + D
        cost = band * p2 * D / max(1, q2) + 200.0 * D
        if best is None or cost < best[0]:
            best = (cost, q2, p2, pat, ntil, d_lo, d_hi)
    # the parity-split combined matmul needs an EVEN period in z2 positions
    # (q̃ odd would flip the even/odd stream roles every row)
    cost, q2, p2, pat, ntil, d_lo, d_hi = best
    if q2 % 2:
        p2, q2 = 2 * p2, 2 * q2
        pat = (np.arange(p2, dtype=np.int64) * q2) // p2
        ntil = (m // p2) * q2 + pat[m % p2]
        d_lo = int((lo_v - ntil).min())
        d_hi = int((hi_v - ntil).max())
    return q2, p2, pat, ntil, d_lo, d_hi


_COMBINED_CACHE: dict = {}


_PICK_CACHE: dict = {}


def pick_design(band_hz: float) -> tuple[int, int]:
    """Smallest (T, K) whose LS design error beats −50 dB over the band.

    Smaller T shrinks the window width Wt = T+D−1 and with it the dominant
    window-assembly bandwidth (~Wt passes over the output stream). Band
    here is the HALF-grid band (≤ 0.249), where T=8 often suffices for the
    default fc=0.25 prototype.
    """
    key = round(band_hz, 3)
    if key not in _PICK_CACHE:
        choice = (12, 4)
        for T in (8, 10, 12):
            done = False
            for K in (3, 4):
                if farrow_design_error_db(T, K, band_hz) < -50.0:
                    choice = (T, K)
                    done = True
                    break
            if done:
                break
        _PICK_CACHE[key] = choice
    return _PICK_CACHE[key]


def combined_select_matrices(step_nom: int, cap: int, band_hz: float,
                             layout: str = "emission"):
    """Host-built matrices folding the K+1 Farrow FIRs AND the periodic
    δ-window selection into ONE banded matmul per parity stream.

    Two column layouts (cached per (step, cap, band, layout)):

    * ``"emission"`` (production): columns ordered j-major —
      column (j, t) of a period selects the z2 sample at window position
      w(j, t) = 2t + s_j of output slot j (s_j the parity offset), so the
      chunk-dot outputs tile the [p2, Wh] output×window grid DIRECTLY in
      emission order: the final combine is one fused multiply-reduce over
      the window axis, with NO per-w reassembly of dot outputs.
      Within a parity stream each output's window positions are CONSECUTIVE
      rows (u(j, t) = u0_j + t), so chunks partition j-ranges with a
      128-row anchor window.
    * ``"window"`` (legacy/fallback): columns ordered (w, j) — used when
      the per-output row span exceeds the chunk height (Wh > Qh, tiny
      periods).

    Output column (j, k, di)·window math: C_k's taps sit at z2 position
    pat[j] + d_lo + di + (t − T//2+1) + σ; even positions land in G_e
    (read from the branch-0 stream), odd in G_o (branch-npfb/2 stream).
    σ (even) shifts all positions non-negative.
    """
    key = (step_nom, cap, round(band_hz, 3), layout)
    if key in _COMBINED_CACHE:
        return _COMBINED_CACHE[key]
    q2, p2, pat, ntil, d_lo, d_hi = periodic_grid(step_nom, cap)
    D = d_hi - d_lo + 1
    Tp, Kp = pick_design(band_hz)
    C = farrow_coeffs(T=Tp, K=Kp, band=band_hz)
    T, K = C.shape[1], C.shape[0] - 1
    d_far = T // 2 - 1
    xi_min = d_lo - d_far
    sigma = 2 * ((max(0, -xi_min) + 1) // 2)
    Qh = q2 // 2
    xi_max = int(pat.max()) + d_hi + (T - 1 - d_far) + sigma
    He = xi_max // 2 + 1
    nov = -(-He // Qh)
    Wt = T + D - 1
    W = Wt * p2
    CH = min(128, Qh)
    Wh = (Wt + 1) // 2
    base0 = d_lo + sigma - d_far
    if layout == "emission" and Wh > CH:
        layout = "window"  # tiny periods: per-output span exceeds a chunk

    chunks = None
    echunks = None
    sj_par = None
    if layout == "emission":
        # EMISSION-ORDER columns (j-major): within parity π, output slot j's
        # window cells are w(j, t) = 2t + s_j (s_j ∈ {0,1} so the cell's z2
        # parity is π), landing on CONSECUTIVE stream rows u(j, t) = u0_j + t.
        # Chunks take j-ranges whose row span fits the CH-row anchor window;
        # their dot outputs tile [p2, Wh] j-major, so the final combine is a
        # single multiply-reduce against the window-coefficient grid.
        echunks = []
        sj_par = []
        for parity in (0, 1):
            s_j = (parity - (pat + base0)) % 2  # [p2]
            u0 = (pat + base0 + s_j - parity) // 2  # [p2], nondecreasing
            cl = []
            ja = 0
            while ja < p2:
                a_c = int(u0[ja])
                jb = ja + 1
                while jb < p2 and int(u0[jb]) + Wh - a_c <= CH:
                    jb += 1
                # columns W-MAJOR within the chunk (col = t·cj + (j−ja)):
                # the dot output then reshapes to [.., Wh, cj] with Wh
                # leading, so concat along j tiles [.., Wh, p2] densely and
                # the final combine multiply-reduce runs with the period
                # axis minor
                cj = jb - ja
                M = np.zeros((CH, Wh * cj), np.float32)
                for j in range(ja, jb):
                    w0 = int(s_j[j])
                    tmax = min(Wh, (Wt - w0 + 1) // 2)
                    rel = int(u0[j]) - a_c
                    cols = np.arange(tmax) * cj + (j - ja)
                    M[rel + np.arange(tmax), cols] = 1.0
                cl.append((a_c, M, (ja, jb)))
                ja = jb
            echunks.append(cl)
            sj_par.append(s_j.astype(np.int32))
    else:
        # WINDOW-ORDER columns (w, j) — legacy layout. Column (w, j) picks
        # the z2 sample at pat[j] + base0 + w; each column has exactly ONE
        # nonzero row, monotone in j within a w-block, so columns split
        # into contiguous j-ranges per 128-row chunk. Downstream the per-w
        # output segments are reassembled by concat (the cost that the
        # emission layout eliminates).
        chunks = ([], [])  # per parity: [(chunk_row, M [CH, ncols], meta)]
        for parity in (0, 1):
            pieces = {}
            for w in range(Wt):
                xi = pat + base0 + w  # [p2] z2 positions, monotone in j
                hot = (xi % 2) == parity
                u = np.maximum(0, (xi - parity) // 2)  # row in this stream
                ch = u // CH
                for c in np.unique(ch):
                    mask = ch == c
                    jj = np.nonzero(mask)[0]
                    ja, jb = int(jj[0]), int(jj[-1]) + 1  # contiguous
                    pieces.setdefault(int(c), []).append(
                        (w, ja, jb, u[ja:jb] - c * CH, hot[ja:jb])
                    )
            for c in sorted(pieces):
                plist = pieces[c]
                ncols = sum(jb - ja for (_w, ja, jb, _u, _h) in plist)
                M = np.zeros((CH, ncols), np.float32)
                off = 0
                meta = []
                for (w, ja, jb, ulocal, hot_l) in plist:
                    idx = np.arange(jb - ja)
                    M[ulocal[hot_l], off + idx[hot_l]] = 1.0
                    meta.append((w, ja, jb, off))
                    off += jb - ja
                chunks[parity].append((c, M, meta))
    CW = np.zeros((D, (K + 1) * Wt), np.float32)
    for di in range(D):
        for k in range(K + 1):
            for t in range(T):
                CW[di, k * Wt + (di + t)] = C[k][t]
    out = dict(q2=q2, p2=p2, pat=pat, ntil=ntil, d_lo=d_lo, d_hi=d_hi,
               D=D, T=T, K=K, Wt=Wt, Wh=Wh, sigma=sigma, Qh=Qh, nov=nov,
               W=W, CH=CH, layout=layout, chunks=chunks, echunks=echunks,
               sj=sj_par, CW=CW)
    _COMBINED_CACHE[key] = out
    return out


def farrow_resample_values(
    xa: jnp.ndarray,
    branches: jnp.ndarray,
    phase: jnp.ndarray,
    step_nom: int,
    n: int,
    out_capacity: int,
    n_m: jnp.ndarray,
    branch: jnp.ndarray,
    lo_bits: jnp.ndarray,
    valid: jnp.ndarray,
    band: float = _BAND,
):
    """Values of the u32 emission schedule via the FIR+Farrow fast path.

    ``xa``: [..., L−1+n] input incl. history (the gather path's layout);
    ``n_m``: traced exact source indices (phase_m >> 24), ``branch``: the
    u32 branch indices (tail fallback), ``lo_bits``: the low-24 fractional
    phase bits per emission, ``valid``: emission mask. Returns y
    [..., out_capacity] matching the gather path within the Farrow design
    error (≈ −55 dB, below the reference's 1/256 branch floor ≈ −45 dB).
    """
    from ._conv import causal_conv_valid

    L = branches.shape[1]
    npfb = branches.shape[0]
    cap = out_capacity
    # farrow operates on the 2×-OVERSAMPLED z grid (branch 0 + branch
    # npfb/2, parity-split), so its design band is half the signal band —
    # ≤ −55 dB for every legal prototype cutoff fc < 0.5
    G = combined_select_matrices(step_nom, cap, min(0.249, band / 2.0),
                                 layout=_LAYOUT)
    p2, D, T, K, Wt = G["p2"], G["D"], G["T"], G["K"], G["Wt"]
    Qh, nov, sigma = G["Qh"], G["nov"], G["sigma"]
    d_lo, d_hi = G["d_lo"], G["d_hi"]
    ntil_np = G["ntil"]
    d = T // 2 - 1
    lookahead = (T - d) // 2 + 2  # future INPUT samples the window reaches
    max_n0 = max(0, (step_nom - 1) >> 24) + 2  # entry offset bound (+margin)

    # Everything below runs PLANAR (re/im as one flattened leading batch)
    # and fully FLATTENED: every conv and the combined matmul see
    # [N, len] / [N·rows, Qh] shapes only (plain 2-D matmuls).
    batch_shape = xa.shape[:-1]
    is_c = jnp.issubdtype(xa.dtype, jnp.complexfloating)
    if is_c:
        xf = jnp.concatenate(
            [jnp.real(xa).reshape((-1, xa.shape[-1])),
             jnp.imag(xa).reshape((-1, xa.shape[-1]))], axis=0
        )  # [2B, L-1+n] f32
    else:
        xf = xa.reshape((-1, xa.shape[-1]))

    # ---- z streams: (h ⊛ x) at integer / half-integer offsets ---------
    # causal_conv_valid(xa, h)[i] = Σ_k h[k]·xa[i+L−1−k] = Σ_j h[L−1−j]·xa[i+j]
    # — the gather path's Σ_j xa[i+j]·br[L−1−j] with h = br: branch 0 is
    # (h⊛x)(i) (the even z2 positions), branch npfb/2 is (h⊛x)(i+½) (odd)
    z_e = causal_conv_valid(xf, branches[0])  # [2B, n]
    z_o = causal_conv_valid(xf, branches[npfb // 2])

    # ---- ONE banded matmul = farrow FIRs ∘ periodic δ-window select ----
    # (combined_select_matrices). Output column (j, k, di) of period r is
    # Σ_t C_k[t]·z2[2n₀ + r·q̃ + pat[j] + d_lo + di + t − d̄]; the even/odd
    # z2 positions come from the two parity streams, each consumed as
    # contiguous row blocks — no interleave, no concat, no gather.
    n0 = jnp.clip((phase >> jnp.uint32(24)).astype(jnp.int32), 0, max_n0)
    rows = -(-cap // p2)
    s2 = sigma // 2
    CH = G["CH"]
    if G["layout"] == "emission":
        anchor_max = max(a for par in G["echunks"] for (a, _M, _r) in par)
    else:
        anchor_max = CH * max(
            (c for par in G["chunks"] for (c, _M, _m) in par), default=0
        )
    need = anchor_max + (rows + 1) * Qh
    right = max(0, need + max_n0 - (z_e.shape[-1] + s2))
    nb = z_e.shape[0]  # 2B planar streams

    # p_m = phase_m >> 23 = 2·n_m + half-bit; relative to the shifted stream
    p_m = ((n_m.astype(jnp.uint32) << 1)
           | ((lo_bits >> jnp.uint32(23)) & 1)).astype(jnp.int32)
    delta = p_m - 2 * n0 - jnp.asarray(ntil_np, jnp.int32)  # traced [cap]
    oh = (
        delta[:, None] == jnp.arange(d_lo, d_hi + 1, dtype=jnp.int32)
    ).astype(jnp.float32)
    mu = (lo_bits & jnp.uint32(0x7FFFFF)).astype(jnp.float32) * jnp.float32(
        2.0 ** -23
    )

    # ---- per-output taps: tiny (δ one-hot) @ CW, Horner in μ ----------
    if G["layout"] == "emission":
        # TRANSPOSED Horner: [Wt, cap] with the output axis minor, the
        # orientation the combine below consumes
        ohT = (
            jnp.arange(d_lo, d_hi + 1, dtype=jnp.int32)[:, None]
            == delta[None, :]
        ).astype(jnp.float32)  # [D, cap]
        A_T = jax.lax.dot_general(
            jnp.asarray(G["CW"].T), ohT, (((1,), (0,)), ((), ())),
            precision=_PREC,
        )  # [(K+1)·Wt, cap]
        coefT = A_T[K * Wt : (K + 1) * Wt]
        for k in range(K - 1, -1, -1):
            coefT = coefT * mu[None, :] + A_T[k * Wt : (k + 1) * Wt]
        coefT_pad = jnp.pad(coefT, [(0, 0), (0, rows * p2 - cap)])
        Wh = G["Wh"]
        ceT = coefT_pad[0::2]  # [Wh, rows·p2]  (w = 2t)
        coT = coefT_pad[1::2]  # [Wt//2, rows·p2] (w = 2t+1)
        if coT.shape[0] < Wh:
            coT = jnp.pad(coT, [(0, Wh - coT.shape[0]), (0, 0)])
        coef_pad = None
    else:
        A = jax.lax.dot_general(
            oh, jnp.asarray(G["CW"]), (((1,), (0,)), ((), ())),
            precision=_PREC,
        )  # [cap, (K+1)·Wt]
        coef = A[:, K * Wt : (K + 1) * Wt]
        for k in range(K - 1, -1, -1):
            coef = coef * mu[:, None] + A[:, k * Wt : (k + 1) * Wt]
        # accumulate at FULL rows·p̃ width (cap-slice once at the end —
        # per-w odd-size slices block fusion); coef zero-padded
        coef_pad = jnp.pad(coef, [(0, rows * p2 - cap), (0, 0)])

    # ---- window select: chunked one-hot dots (K-independent) ----------
    # 2-pass split computed ONCE at stream level: the rhs is exactly
    # representable (0/1), so dot(hi) + dot(lo) with hi = bf16-rounded
    # stream reconstructs the f32 selection (both dots at HIGHEST).
    def stream_hi_lo(z):
        zp = jnp.pad(z, [(0, 0), (s2, right)])
        zs = jax.lax.dynamic_slice_in_dim(zp, n0, need, axis=-1)
        zhi = jax.lax.optimization_barrier(
            zs.astype(jnp.bfloat16).astype(jnp.float32)
        )
        zlo = jax.lax.optimization_barrier(zs - zhi)
        return zhi, zlo

    def chunk_dot(zhi, zlo, anchor, M):
        Mj = jnp.asarray(M)
        acc = None
        for flat in (zhi, zlo):
            seg = flat[:, anchor : anchor + (rows + 1) * Qh]
            xc = seg.reshape((nb, rows + 1, Qh))[:, :rows, :CH]
            d_ = jax.lax.dot_general(
                xc.reshape((-1, CH)), Mj, (((1,), (0,)), ((), ())),
                precision=_PREC,
            )
            acc = d_ if acc is None else acc + d_
        return acc  # [nb·rows, ncols]

    if G["layout"] == "emission":
        # ---- y: dot outputs land in EMISSION ORDER ---------------------
        # per parity the chunk outputs tile the [Wh, p2] window×output grid
        # w-major (window axis leading, period axis minor — dense);
        # the combine is one fused multiply-reduce against the parity's
        # window-coefficient grid (coef[m, 2t + s_j]) — no per-w
        # reassembly.
        y = None
        for parity, z in ((0, z_e), (1, z_o)):
            zhi, zlo = stream_hi_lo(z)
            sjt = jnp.asarray(np.tile(G["sj"][parity], rows))  # [rows·p2]
            cpiT = jnp.where(sjt[None, :] == 1, coT, ceT)  # [Wh, rows·p2]
            cpi4 = jnp.swapaxes(cpiT.reshape((Wh, rows, p2)), 0, 1)
            # multiply-reduce PER CHUNK (before any concat): concatenating
            # the [nb·rows, Wh, p2] grid first materializes ~145 MB per
            # parity of dot outputs twice over — per-chunk reduction feeds
            # only the [nb, rows, cj] results into the concat
            terms = []
            for (a_c, M, (ja, jb)) in G["echunks"][parity]:
                O_c = chunk_dot(zhi, zlo, a_c, M).reshape(
                    (nb, rows, Wh, jb - ja)
                )
                terms.append(
                    jnp.sum(O_c * cpi4[None, :, :, ja:jb], axis=-2)
                )
            term = jnp.concatenate(terms, axis=-1)  # [nb, rows, p2]
            y = term if y is None else y + term
        y = y.reshape((nb, rows * p2))[:, :cap]
    else:
        # ---- legacy: window-order columns + per-w reassembly -----------
        # (an accumulate loop over windows rather than one stacked
        # [nb, Wt, cap] tensor and a single reduce)
        Oc = {}
        for parity, z in ((0, z_e), (1, z_o)):
            zhi, zlo = stream_hi_lo(z)
            for (c, M, meta) in G["chunks"][parity]:
                Oc[(parity, c)] = chunk_dot(zhi, zlo, c * CH, M)
        y = None
        for w in range(Wt):
            parts = None
            for parity in (0, 1):
                segs = []
                for (c, M, meta) in G["chunks"][parity]:
                    for (pw, ja, jb, off) in meta:
                        if pw == w:
                            segs.append(
                                (ja, Oc[(parity, c)][:, off : off + jb - ja])
                            )
                segs.sort(key=lambda t: t[0])
                part = jnp.concatenate([s[1] for s in segs], axis=1)
                parts = part if parts is None else parts + part
            term = parts.reshape((nb, rows * p2)) * coef_pad[:, w]
            y = term if y is None else y + term
        y = y[:, :cap]
    # back to complex + original batch shape
    if is_c:
        B = y.shape[0] // 2
        y = jax.lax.complex(y[:B], y[B:])
    y = y.reshape(batch_shape + (cap,))

    # ---- exact-dotprod head (farrow window would reach pre-block z) ----
    # The window spans z2 positions [p_m − (T//2−1), …]; positions < 0 fall
    # in the zero LEFT pad (true history z samples are not computed), so
    # emissions with p_m ≤ T//2−1 — only possible while n_m is within a
    # couple of samples of the block start — use the reference dotprod.
    # (Visible as an elevated first-emission error on every block whose
    # entry phase is nonzero; blocks at phase 0 hid it in the transient.)
    head_lim = (T // 2) // 2 + 1
    head_zone = n_m <= head_lim
    hcap = min(cap, int((head_lim + 1) * (1 << 24) // step_nom) + 3)
    if hcap > 0:
        starts_h = jnp.clip(n_m[:hcap], 0, n - 1)
        fidx_h = starts_h[:, None] + jnp.arange(L)
        frames_h = xa[..., fidx_h]  # [..., hcap, L]
        hb_h = jnp.take(branches, branch[:hcap], axis=0)
        y_h = jnp.einsum(
            "...cl,cl->...c", frames_h, hb_h[:, ::-1], precision=_PREC
        )
        pad_h = jnp.zeros(y.shape[:-1] + (cap - hcap,), y_h.dtype)
        y_head_full = jnp.concatenate([y_h, pad_h], axis=-1)
        y = jnp.where(head_zone, y_head_full, y)

    # ---- exact-dotprod tail (farrow window would need future inputs) ---
    # A slot is in the tail zone only when n_m ≥ n − lookahead − max_n0.
    # Anchor the exact window to the EMISSION SCHEDULE, not the capacity:
    # n_m ≤ entry_n0 + ((m·step)>>24) + 1 with entry_n0 ≤ max_n0, so the
    # first slot index that can reach the zone is bounded host-side from
    # the nominal step. (Anchoring to out_capacity zeroed valid tail
    # emissions whenever capacity exceeded the emission count.)
    tail_zone = n_m >= (n - lookahead - max_n0)
    first = ((n - lookahead - 2 * max_n0 - 1) << 24) // step_nom - 4
    sl = max(0, min(cap, first))
    if sl < cap:
        starts_t = jnp.clip(n_m[sl:], 0, n - 1)
        frame_idx = starts_t[:, None] + jnp.arange(L)
        frames_t = xa[..., frame_idx]  # [..., tcap, L] — small traced gather
        hb_t = jnp.take(branches, branch[sl:], axis=0)  # [tcap, L]
        y_t = jnp.einsum(
            "...cl,cl->...c", frames_t, hb_t[:, ::-1], precision=_PREC
        )
        pad_t = jnp.zeros(y.shape[:-1] + (sl,), y_t.dtype)
        y_tail_full = jnp.concatenate([pad_t, y_t], axis=-1)
        y = jnp.where(tail_zone, y_tail_full, y)
    return jnp.where(valid, y, 0)
