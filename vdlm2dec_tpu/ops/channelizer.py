"""Batched channelizer: mixer + integrate-and-dump decimator as matmuls.

The reference runs one thread per channel doing a scalar LO multiply and a
fractional integrate-and-dump (21/SDRCLK accumulator, d8psk.c:353-381).  Here
the same arithmetic is re-expressed block-parallel:

  * the decimation pattern repeats every P_in = 4*SDRCLK input samples,
    emitting exactly 84 output samples (1 ms at 84 kHz) — true for all three
    supported input rates (2 Msps/500, 5 Msps/1250, 6 Msps/1500);
  * within a period the "emit sample m = mean of inputs [b_m, b_{m+1})"
    operation is a constant (P_in, 84) aggregation matrix A;
  * the LO for channel c factorises as LO[c, p*P_in + n] =
    phase[c, p] * lo0[c, n] because the reference's wrapped LO table length
    (fs/25 kHz) divides P_in;

so the whole channelizer is:  Y[c, p, :] = (x[p, :] * lo0[c, :] * phase[c, p]) @ A
— an elementwise pass plus one matmul, batched over channels and
periods, with no sequential state.

Semantics checked against golden.dsp.mix_and_decimate in tests.
"""
from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import STEPRATE

TWO_PI = 2.0 * math.pi


def period_for(sdrclk: int) -> tuple[int, int]:
    """(input samples, output samples) of one decimation period."""
    p_in = 4 * sdrclk
    p_out = p_in * 21 // sdrclk          # = 84
    assert p_in * 21 % sdrclk == 0
    return p_in, p_out


@functools.lru_cache(maxsize=8)
def aggregation_matrix(sdrclk: int) -> np.ndarray:
    """(P_in, 84) float32: A[n, m] = 1/len_m if input n feeds output m.

    Window boundaries replicate the clk += 21; if clk >= SDRCLK emit pattern:
    output m covers inputs n with floor(21*n/sdrclk) == m, i.e. the emit
    happens at the sample where the accumulator crosses.
    """
    p_in, p_out = period_for(sdrclk)
    # input n belongs to the output emitted at the next accumulator crossing;
    # the number of crossings strictly before consuming n is floor(21n/sdrclk)
    owner = (21 * np.arange(p_in)) // sdrclk   # output index owning input n
    a = np.zeros((p_in, p_out), dtype=np.float64)
    for m in range(p_out):
        idx = np.nonzero(owner == m)[0]
        a[idx, m] = 1.0 / len(idx)
    return a.astype(np.float32)


@functools.lru_cache(maxsize=8)
def fir_aggregation_matrix(
    sdrclk: int, fs: int, n_taps: int = 531, cutoff_hz: float = 12_500.0,
    beta: float = 8.0,
) -> tuple[np.ndarray, int]:
    """FIR alternative to the boxcar integrate-and-dump: (P_in + 2*pad, 84)
    windowed-sinc decimation matrix + pad size.

    The reference's boxcar (~24 samples at 2 Msps) attenuates the adjacent
    25 kHz channel by only ~1 dB, so strong neighbours leak into the demod
    and can fire garbage sync triggers.  A Kaiser-windowed sinc with the
    same output instants gives >60 dB adjacent-channel rejection at ~1.3x
    the channelizer matmul cost.  Output sample m keeps the boxcar window's
    center as its nominal instant, so downstream timing recovery is
    unchanged.  Opt-in: frame-level parity tests run against the boxcar.
    """
    p_in, p_out = period_for(sdrclk)
    owner = (21 * np.arange(p_in)) // sdrclk
    centers = np.array(
        [np.nonzero(owner == m)[0].mean() for m in range(p_out)]
    )
    pad = (n_taps - 1) // 2
    n = np.arange(-pad, pad + 1)
    x = 2.0 * cutoff_hz / fs * n
    h = (2.0 * cutoff_hz / fs) * np.sinc(x)
    h *= np.kaiser(n_taps, beta)
    h /= h.sum()
    a = np.zeros((p_in + 2 * pad, p_out), dtype=np.float64)
    grid = np.arange(p_in + 2 * pad) - pad       # raw index within period
    for m in range(p_out):
        rel = grid - centers[m]
        ok = np.abs(rel) <= pad
        idx = np.round(rel[ok]).astype(int) + pad
        a[ok, m] = h[idx]
    return a.astype(np.float32), pad


@functools.lru_cache(maxsize=32)
def lo_tables(
    f_offsets: tuple[float, ...], fs: int, sdrclk: int, wrap: bool
) -> tuple[np.ndarray, int]:
    """Per-channel base LO over one period: (C, P_in) complex64, + table len.

    wrap=True replicates the reference's length fs/25kHz phase-wrapping LO
    table; wrap=False is a continuous-phase LO (identical when the offset is
    a multiple of 25 kHz).
    """
    p_in, _ = period_for(sdrclk)
    tbl = fs // STEPRATE
    assert p_in % tbl == 0 or not wrap
    n = np.arange(p_in)
    fo = np.asarray(f_offsets, dtype=np.float64)[:, None]
    if wrap:
        idx = n % tbl
        lo = np.exp(-1j * TWO_PI * fo / fs * idx)
    else:
        lo = np.exp(-1j * TWO_PI * fo / fs * n)
    return lo.astype(np.complex64), tbl


@functools.lru_cache(maxsize=32)
def dft_tables(
    f_offsets: tuple[float, ...], fs: int, sdrclk: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Residue-space channelizer tables ("wrapped-LO filterbank").

    The reference's wrapped LO (lo_wrap=True, d8psk.c:353-358) is periodic
    with tbl = fs/25 kHz samples, and tbl always divides the decimation
    period (p_in/tbl = 25).  Each input sample n therefore contributes
    lo[c, n%tbl] * x[n] / len(m) to exactly one (residue r = n%tbl,
    output m = owner(n)) cell — integrate-and-dump windows (~p_in/84
    samples) are shorter than tbl, so the map n -> (r, m) is injective.
    The whole channelizer becomes

        z[b, r, m] = x[b, idx[r, m]] * invlen[m]        (pure gather)
        y[c, b, m] = sum_r w[c, r] * z[b, r, m]         (one matmul)

    which is EXACTLY the same products as the per-channel mix+dump but
    O(tbl) instead of O(p_in) multiply-accumulates per output sample
    (25/84 the FLOPs of the dense formulation at 84 outputs/period) and —
    decisive at hundreds of channels — without the (C, B, P_in) mixed
    intermediate.  Returns (w (C, tbl) complex64, idx (tbl, p_out) int32
    with -1 for empty cells, mask (tbl, p_out) f32, invlen (p_out,) f32).
    """
    p_in, p_out = period_for(sdrclk)
    tbl = fs // STEPRATE
    assert p_in % tbl == 0
    owner = (21 * np.arange(p_in)) // sdrclk
    counts = np.bincount(owner, minlength=p_out)
    idx = np.full((tbl, p_out), -1, np.int32)
    for n in range(p_in):
        r, m = n % tbl, owner[n]
        assert idx[r, m] == -1, "integrate window longer than the LO table"
        idx[r, m] = n
    mask = (idx >= 0).astype(np.float32)
    invlen = (1.0 / counts).astype(np.float32)
    fo = np.asarray(f_offsets, dtype=np.float64)[:, None]
    r = np.arange(tbl)[None, :]
    w = np.exp(-1j * TWO_PI * fo / fs * r).astype(np.complex64)
    return w, np.maximum(idx, 0), mask, invlen


@functools.lru_cache(maxsize=32)
def dft_qr_tables(f_offsets: tuple[float, ...], fs: int, sdrclk: int,
                  split: bool) -> tuple[np.ndarray, np.ndarray]:
    """Residue-space channelizer as TWO matmuls, no gather.

    p_in = (p_in/tbl) * tbl always holds (25 at every supported rate),
    so x reshapes losslessly to (B, Q, tbl) with residue r as the minor
    axis, and the residue-space tensor becomes a batched contraction
    over Q instead of a 27M-element gather:

        z[b, r, m] = sum_q x2[b, q, r] * A2[q, r, m]

    with A2[q, r, owner(q*tbl+r)] = invlen — at most one nonzero m per
    (q, r), so the products are EXACTLY the wrapped-LO mix+dump's.

    split=True permutes the r axis to the split-phase cu8 ingest layout
    (ops: even samples then odd samples — position n at plane column
    n>>1 (+ half for odd), which maps residue r to column r>>1 +
    (r&1)*tbl/2 within each Q-row).  Returns (w (C, tbl) complex64 with
    the SAME r permutation, A2 (Q, tbl, p_out) float32)."""
    p_in, p_out = period_for(sdrclk)
    tbl = fs // STEPRATE
    assert p_in % tbl == 0
    q_n = p_in // tbl
    owner = (21 * np.arange(p_in)) // sdrclk
    counts = np.bincount(owner, minlength=p_out)
    invlen = 1.0 / counts
    a2 = np.zeros((q_n, tbl, p_out), dtype=np.float64)
    for n in range(p_in):
        q, r = n // tbl, n % tbl
        a2[q, r, owner[n]] = invlen[owner[n]]
    fo = np.asarray(f_offsets, dtype=np.float64)[:, None]
    w = np.exp(-1j * TWO_PI * fo / fs * np.arange(tbl)[None, :])
    if split:
        assert tbl % 2 == 0
        # column k of the split x2 row holds residue rho(k):
        # even k' <- r = 2k', k' + tbl/2 <- r = 2k'+1
        rho = np.concatenate([2 * np.arange(tbl // 2),
                              2 * np.arange(tbl // 2) + 1])
        a2 = a2[:, rho, :]
        w = w[:, rho]
    return w.astype(np.complex64), a2.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("split", "compute"))
def _channelize_dft_qr_jit(x_r, x_i, w_r, w_i, a2, split: bool = False,
                           compute="f32"):
    """Gather-free residue-space channelize: x (B, P_in) planes (sample
    order, or split-phase order with split=True + matching a2/w) ->
    (C, B*84) planes.

    split layout note: each true q-row holds its 40 even samples in the
    first plane half and its 40 odd in the second, so the halves
    reshape to (B, Q, tbl/2) SEPARATELY and contract against the even/
    odd halves of a2, summing the two partial z's — no residue-axis
    concat (a minor-dim concat would relayout) and no reshape of the
    whole split plane (which would mix q pairs)."""
    b = x_r.shape[0]
    q_n, tbl, p_out = a2.shape
    dt, prec = mm_mode(compute)
    a2 = a2.astype(dt)

    def z_of(x):
        if split:
            h = x.shape[1] // 2
            ze = jnp.einsum("bqr,qrm->brm",
                            x[:, :h].reshape(b, q_n, tbl // 2).astype(dt),
                            a2[:, : tbl // 2],
                            preferred_element_type=jnp.float32,
                            precision=prec)
            zo = jnp.einsum("bqr,qrm->brm",
                            x[:, h:].reshape(b, q_n, tbl // 2).astype(dt),
                            a2[:, tbl // 2:],
                            preferred_element_type=jnp.float32,
                            precision=prec)
            return jnp.concatenate([ze, zo], axis=1)
        return jnp.einsum("bqr,qrm->brm", x.reshape(b, q_n, tbl).astype(dt),
                          a2, preferred_element_type=jnp.float32,
                          precision=prec)

    zr = z_of(x_r)
    zi = z_of(x_i)
    zr, zi = zr.astype(dt), zi.astype(dt)
    w_r, w_i = w_r.astype(dt), w_i.astype(dt)
    yr = (jnp.einsum("cr,brm->cbm", w_r, zr,
                     preferred_element_type=jnp.float32, precision=prec)
          - jnp.einsum("cr,brm->cbm", w_i, zi,
                       preferred_element_type=jnp.float32, precision=prec))
    yi = (jnp.einsum("cr,brm->cbm", w_r, zi,
                     preferred_element_type=jnp.float32, precision=prec)
          + jnp.einsum("cr,brm->cbm", w_i, zr,
                       preferred_element_type=jnp.float32, precision=prec))
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


def split_phase_index(idx: np.ndarray, p_in: int) -> np.ndarray:
    """Remap per-period sample indices to the split-phase plane layout
    [even samples | odd samples] that the fast cu8 ingest emits
    (pipeline._raw_to_planes_split): position n lives at
    (n >> 1) + (n & 1) * (p_in // 2).  Precomputed so the residue-space
    gather consumes the split layout directly — the interleave that a
    sample-ordered plane would need is never materialized."""
    assert p_in % 2 == 0
    return ((idx >> 1) + (idx & 1) * (p_in // 2)).astype(idx.dtype)


def resolve_chan_impl(
    f_offsets, fs: int, sdrclk: int, lo_wrap: bool = True,
    filter_mode: str = "boxcar",
) -> str:
    """Pick the channelizer implementation for impl="auto".

    The residue-space ("dft") formulation computes the SAME products as
    the dense mix+dump in O(tbl)=O(fs/25 kHz) MACs per output instead of
    O(P_in), with no (C, B, P_in) mixed intermediate.
    It is exact only when every channel's LO is tbl-periodic, i.e. each
    offset is a 25 kHz-raster multiple (true for all real VDL plans:
    channels sit on the raster and chooseFc lands fc on it), under the
    reference's wrapped-LO boxcar mode.  Off-raster plans, the FIR
    filter or lo_wrap=False keep the dense matmul path."""
    p_in, _ = period_for(sdrclk)
    tbl = fs // STEPRATE
    on_raster = all(
        abs(f - STEPRATE * round(f / STEPRATE)) < 1e-6 for f in f_offsets
    )
    if (lo_wrap and filter_mode == "boxcar"
            and fs % STEPRATE == 0 and tbl > 0 and p_in % tbl == 0
            and on_raster):
        return "dft"
    return "matmul"


def mm_mode(compute: str):
    """(cast dtype, matmul precision) for a compute mode.

    "f32": HIGHEST = true f32 products (no TF32 rounding of the inputs).
    "bf16": bfloat16 operands with f32 accumulation — ~0.5% amplitude
    error on decimated samples, absorbed by the sync metric / soft
    slicer (frame-parity tested in test_bf16_mode.py); half the operand
    memory traffic."""
    if compute == "bf16":
        return jnp.bfloat16, jax.lax.Precision.DEFAULT
    return jnp.float32, jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("compute",))
def _channelize_dft_jit(x_r, x_i, w_r, w_i, idx, mask, invlen,
                        compute="f32"):
    """Residue-space channelize: x (B, P_in) f32 pair -> (C, B*84) pair.

    Gather into (B, tbl, P_out) residue space, then one matmul over the
    tbl axis per channel.  Valid for lo_wrap=True only (the wrap IS the
    periodicity this exploits)."""
    b = x_r.shape[0]
    tbl, p_out = idx.shape
    dt, prec = mm_mode(compute)
    g = mask * invlen[None, :]
    zr = (x_r[:, idx.reshape(-1)].reshape(b, tbl, p_out) * g).astype(dt)
    zi = (x_i[:, idx.reshape(-1)].reshape(b, tbl, p_out) * g).astype(dt)
    w_r, w_i = w_r.astype(dt), w_i.astype(dt)
    yr = (jnp.einsum("cr,brm->cbm", w_r, zr,
                     preferred_element_type=jnp.float32, precision=prec)
          - jnp.einsum("cr,brm->cbm", w_i, zi,
                       preferred_element_type=jnp.float32, precision=prec))
    yi = (jnp.einsum("cr,brm->cbm", w_r, zi,
                     preferred_element_type=jnp.float32, precision=prec)
          + jnp.einsum("cr,brm->cbm", w_i, zr,
                       preferred_element_type=jnp.float32, precision=prec))
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


def _near_sqrt_factors(n: int) -> tuple[int, int]:
    """n = a*b with a <= b and b-a minimal (FFT radix split)."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


@functools.lru_cache(maxsize=32)
def pfb_tables(f_offsets: tuple[float, ...], fs: int, sdrclk: int):
    """Oversampled-filterbank channelizer tables (PERF.md lever 3).

    The residue-space channelizer's per-channel matmul y[c] = w[c] @ z is,
    for channels on the 25 kHz raster, a DFT over the tbl residues
    evaluated at bins k_c = fo_c / 25 kHz: w[c, r] = e^{-2pi i k_c r/tbl}.
    Computing ALL tbl bins by FFT costs O(tbl log tbl) instead of
    O(C*tbl) — the classic oversampled polyphase filterbank (boxcar
    prototype = the reference's integrate-and-dump, output on the 84 kHz
    grid like every other impl).  The DFT is factorized Cooley-Tukey with
    tbl = a*b (near-sqrt): DFT_a matmul -> twiddle -> DFT_b matmul, all
    on re/im f32 planes — O(a+b) per output element vs the
    dft impl's O(C); crossover at roughly C > a+b (57 at 20 Msps,
    18 at 2 Msps).

    Returns (a, b, dft_a (a,a,2), twiddle (a,b,2), dft_b (b,b,2),
    bins (C, 2) int32 [k1, k2]) with k = k1 + a*k2 = fo/STEP mod tbl.
    """
    tbl = fs // STEPRATE
    a, b = _near_sqrt_factors(tbl)
    for fo in f_offsets:
        k = fo / STEPRATE
        assert abs(k - round(k)) < 1e-9, (
            f"pfb channelizer needs raster-aligned offsets, got {fo}"
        )
    bins = np.array([int(round(fo / STEPRATE)) % tbl for fo in f_offsets],
                    dtype=np.int64)
    k1, k2 = bins % a, bins // a
    r1 = np.arange(a)
    r2 = np.arange(b)
    # Y[k1 + a*k2] = sum_{r2} W_tbl^{r2 k1} W_b^{r2 k2}
    #                 * sum_{r1} W_a^{r1 k1} z[r1*b + r2]
    dft_a = np.exp(-2j * np.pi * np.outer(r1, r1) / a)        # [k1, r1]
    tw = np.exp(-2j * np.pi * np.outer(r1, r2) / tbl)         # [k1, r2]
    dft_b = np.exp(-2j * np.pi * np.outer(r2, r2) / b)        # [k2, r2]

    def planes(m):
        return np.stack([m.real, m.imag], axis=-1).astype(np.float32)

    return (a, b, planes(dft_a), planes(tw), planes(dft_b),
            np.stack([k1, k2], axis=1).astype(np.int32))


@functools.partial(jax.jit, static_argnames=("a", "b", "split", "compute"))
def _channelize_pfb_jit(x_r, x_i, a2, dfa, tw, dfb, bins,
                        a: int, b: int, split: bool = False,
                        compute="f32"):
    """Residue contraction + factorized-DFT filterbank: x (B, P_in) f32
    pair -> (C, B*84) pair.  The residue-space tensor comes from the same
    gather-free (B, Q, tbl) x (Q, tbl, 84) contraction as the dft impl
    (dft_qr_tables);
    the (C, tbl) matmul is replaced by DFT_a -> twiddle -> DFT_b over
    all tbl bins, then a bin gather for the requested channels.

    The DFT factorization needs z in TRUE residue order (r = r1*b + r2);
    with split=True (a2 in the split-phase cu8 layout) the even/odd
    half-contractions produce true residues [0,2,..] and [1,3,..], which
    interleave back via a middle-axis stack+reshape (the 84-wide minor
    dim stays intact)."""
    bsz = x_r.shape[0]
    q_n, tbl, p_out = a2.shape
    dt, prec = mm_mode(compute)
    a2 = a2.astype(dt)

    def z_of(x):
        if split:
            h = x.shape[1] // 2
            ze = jnp.einsum("bqr,qrm->brm",
                            x[:, :h].reshape(bsz, q_n, tbl // 2).astype(dt),
                            a2[:, : tbl // 2],
                            preferred_element_type=jnp.float32,
                            precision=prec)
            zo = jnp.einsum("bqr,qrm->brm",
                            x[:, h:].reshape(bsz, q_n, tbl // 2).astype(dt),
                            a2[:, tbl // 2:],
                            preferred_element_type=jnp.float32,
                            precision=prec)
            # true residue r = 2*r1 + parity: interleave the halves
            return jnp.stack([ze, zo], axis=2).reshape(bsz, tbl, p_out)
        return jnp.einsum("bqr,qrm->brm",
                          x.reshape(bsz, q_n, tbl).astype(dt), a2,
                          preferred_element_type=jnp.float32,
                          precision=prec)

    # residue r = r1*b + r2 -> (B, a, b, 84)
    zr = z_of(x_r).reshape(bsz, a, b, p_out).astype(dt)
    zi = z_of(x_i).reshape(bsz, a, b, p_out).astype(dt)

    def cmatmul(spec, mr, mi, vr, vi):
        rr = jnp.einsum(spec, mr, vr, preferred_element_type=jnp.float32,
                        precision=prec)
        ri = jnp.einsum(spec, mr, vi, preferred_element_type=jnp.float32,
                        precision=prec)
        ir = jnp.einsum(spec, mi, vr, preferred_element_type=jnp.float32,
                        precision=prec)
        ii = jnp.einsum(spec, mi, vi, preferred_element_type=jnp.float32,
                        precision=prec)
        return rr - ii, ri + ir

    dfa_r, dfa_i = dfa[..., 0].astype(dt), dfa[..., 1].astype(dt)
    dfb_r, dfb_i = dfb[..., 0].astype(dt), dfb[..., 1].astype(dt)
    # stage 1: DFT over r1 -> (B, k1, r2, 84)
    ar, ai = cmatmul("kr,brcm->bkcm", dfa_r, dfa_i, zr, zi)
    # twiddle W_tbl^{k1 r2}
    twr, twi = tw[..., 0], tw[..., 1]
    br = ar * twr[None, :, :, None] - ai * twi[None, :, :, None]
    bi = ar * twi[None, :, :, None] + ai * twr[None, :, :, None]
    # stage 2: DFT over r2 -> (B, k1, k2, 84)
    yr, yi = cmatmul("kc,bqcm->bqkm", dfb_r, dfb_i,
                     br.astype(dt), bi.astype(dt))
    # bin gather for the channel set, -> (C, B*84)
    k1, k2 = bins[:, 0], bins[:, 1]
    yr = yr[:, k1, k2, :].transpose(1, 0, 2)
    yi = yi[:, k1, k2, :].transpose(1, 0, 2)
    c = k1.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


def period_phases(
    f_offsets: tuple[float, ...], fs: int, sdrclk: int, wrap: bool, n_periods: int,
    start_period: int = 0,
) -> np.ndarray:
    """(C, B) complex64 phase of each period start.

    With the reference's wrapped LO table the phase resets every table length
    which divides P_in, so the per-period phase is exactly 1.  With the
    continuous LO it advances by exp(-j*2pi*fo*P_in/fs) per period.
    """
    p_in, _ = period_for(sdrclk)
    fo = np.asarray(f_offsets, dtype=np.float64)[:, None]
    p = np.arange(start_period, start_period + n_periods)[None, :]
    if wrap:
        return np.ones((len(f_offsets), n_periods), dtype=np.complex64)
    ang = -TWO_PI * fo * (p_in / fs) * p
    return np.exp(1j * ang).astype(np.complex64)


@functools.partial(jax.jit, static_argnames=("pad", "compute"))
def _channelize_fir_jit(x_r, x_i, lo_r, lo_i, ph_r, ph_i, a_ext, pad,
                        compute="f32"):
    """FIR decimation: overlapped (P_in + 2*pad) windows @ a_ext.

    x (B, P_in) f32 pair; output (C, B*84) pair.  Taps spill across period
    boundaries, so the mixed flat stream is zero-padded and re-windowed with
    halo pad (block edges see zeros — use generous stream margins).
    """
    b, p_in = x_r.shape
    c = lo_r.shape[0]
    # mixed flat stream per channel
    mr = x_r[None] * lo_r[:, None, :] - x_i[None] * lo_i[:, None, :]
    mi = x_r[None] * lo_i[:, None, :] + x_i[None] * lo_r[:, None, :]
    zr = (mr * ph_r[:, :, None] - mi * ph_i[:, :, None]).reshape(c, -1)
    zi = (mr * ph_i[:, :, None] + mi * ph_r[:, :, None]).reshape(c, -1)
    zr = jnp.pad(zr, ((0, 0), (pad, pad)))
    zi = jnp.pad(zi, ((0, 0), (pad, pad)))
    idx = jnp.arange(p_in + 2 * pad)[None, :] + (jnp.arange(b) * p_in)[:, None]
    dt, prec = mm_mode(compute)
    wr = zr[:, idx].astype(dt)                 # (C, B, P_in + 2*pad)
    wi = zi[:, idx].astype(dt)
    a_ext = a_ext.astype(dt)
    yr = jnp.einsum("cbn,nm->cbm", wr, a_ext,
                    preferred_element_type=jnp.float32, precision=prec)
    yi = jnp.einsum("cbn,nm->cbm", wi, a_ext,
                    preferred_element_type=jnp.float32, precision=prec)
    return yr.reshape(c, -1), yi.reshape(c, -1)


@functools.partial(jax.jit, static_argnames=("interleave", "compute"))
def _channelize_jit(x_r, x_i, lo_r, lo_i, ph_r, ph_i, a, interleave=False,
                    compute="f32"):
    """Core: x (B, P_in) f32 pair, lo (C, P_in), ph (C, B), a (P_in, P_out).

    Returns (C, B*P_out) complex64 as (real, imag) f32 pair.
    compute="f32": all matmuls in true f32; "bf16": see mm_mode.
    """
    # mixed[c, b, n] = x[b, n] * lo[c, n]  (complex)
    mr = x_r[None, :, :] * lo_r[:, None, :] - x_i[None, :, :] * lo_i[:, None, :]
    mi = x_r[None, :, :] * lo_i[:, None, :] + x_i[None, :, :] * lo_r[:, None, :]
    # apply period phase
    zr = mr * ph_r[:, :, None] - mi * ph_i[:, :, None]
    zi = mr * ph_i[:, :, None] + mi * ph_r[:, :, None]
    # aggregate: (C, B, P_in) @ (P_in, P_out)
    dt, prec = mm_mode(compute)
    zr, zi, a = zr.astype(dt), zi.astype(dt), a.astype(dt)
    yr = jnp.einsum("cbn,nm->cbm", zr, a, preferred_element_type=jnp.float32,
                    precision=prec)
    yi = jnp.einsum("cbn,nm->cbm", zi, a, preferred_element_type=jnp.float32,
                    precision=prec)
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


class Channelizer:
    """Stateless-per-block wideband -> per-channel 84 kHz channelizer.

    Parameters mirror the reference front end: fs (input rate), sdrclk
    (decimator modulus, fs/4000), per-channel offsets Fo = Fr - Fc
    (rtl.c:246) or Fr - (Fc + fs/4) (air.c:182-185).
    """

    def __init__(
        self,
        f_offsets: list[float],
        fs: int = 2_000_000,
        sdrclk: int | None = None,
        lo_wrap: bool = True,
        real_input: bool = False,
        filter_mode: str = "boxcar",
        impl: str = "matmul",
        compute: str = "f32",
    ):
        assert compute in ("f32", "bf16")
        self.compute = compute
        self.fs = fs
        self.sdrclk = sdrclk if sdrclk is not None else fs // 4000
        self.f_offsets = tuple(float(f) for f in f_offsets)
        self.lo_wrap = lo_wrap
        self.real_input = real_input
        assert filter_mode in ("boxcar", "fir")
        if impl == "auto":
            impl = resolve_chan_impl(
                self.f_offsets, fs, self.sdrclk, lo_wrap, filter_mode)
        assert impl in ("matmul", "dft", "pfb")
        assert impl == "matmul" or (lo_wrap and filter_mode == "boxcar"), (
            "the residue-space (dft/pfb) channelizers require lo_wrap=True "
            "boxcar mode"
        )
        self.filter_mode = filter_mode
        self.impl = impl
        self.p_in, self.p_out = period_for(self.sdrclk)
        lo, _ = lo_tables(self.f_offsets, fs, self.sdrclk, lo_wrap)
        self._lo = lo
        # device-resident constants (uploads once; per-call jnp.asarray of
        # host arrays would re-transfer every block)
        self._lo_r = jnp.asarray(np.ascontiguousarray(lo.real))
        self._lo_i = jnp.asarray(np.ascontiguousarray(lo.imag))
        self._a = jnp.asarray(aggregation_matrix(self.sdrclk))
        if filter_mode == "fir":
            a_fir, pad = fir_aggregation_matrix(self.sdrclk, fs)
            self._a_fir = jnp.asarray(a_fir)
            self._fir_pad = pad
        if impl in ("dft", "pfb"):
            # residue eligibility check (raises early on bad plans); the
            # qr tables themselves build lazily per layout in qr_tables()
            dft_tables(self.f_offsets, fs, self.sdrclk)
            self._qr_cache: dict[bool, tuple] = {}
        if impl == "pfb":
            a, b, dfa, tw, dfb, bins = pfb_tables(
                self.f_offsets, fs, self.sdrclk)
            self._pfb_a, self._pfb_b = a, b
            self._pfb_dfa = jnp.asarray(dfa)
            self._pfb_tw = jnp.asarray(tw)
            self._pfb_dfb = jnp.asarray(dfb)
            self._pfb_bins = jnp.asarray(bins)
        self._period_cursor = 0

    @property
    def n_channels(self) -> int:
        return len(self.f_offsets)

    def out_rate(self) -> float:
        return self.fs * 21.0 / self.sdrclk

    def __call__(
        self, x: np.ndarray | jnp.ndarray, period0: int | None = None
    ) -> jnp.ndarray:
        """x: (T,) wideband block, T a multiple of P_in.  Returns
        (C, T*21/sdrclk, 2) float32 decimated channels (re/im planes —
        the device pipeline is complex-free by design).

        period0: explicit absolute period index of x[0] (blockwise /
        overlapping reads); when given, the internal cursor is untouched,
        so re-channelizing overlapping segments stays phase-exact for
        lo_wrap=False."""
        if x.ndim == 2 and x.shape[-1] == 2:
            # (T, 2) re/im planes (device-friendly; complex64 never touches
            # the device)
            t = x.shape[0]
            assert t % self.p_in == 0, f"block {t} not a multiple of {self.p_in}"
            b = t // self.p_in
            ph = period_phases(
                self.f_offsets, self.fs, self.sdrclk, self.lo_wrap, b,
                self._period_cursor if period0 is None else period0,
            )
            if period0 is None:
                self._period_cursor += b
            x = jnp.asarray(x, dtype=jnp.float32)
            x_r = x[:, 0].reshape(b, self.p_in)
            x_i = (
                jnp.zeros_like(x_r)
                if self.real_input
                else x[:, 1].reshape(b, self.p_in)
            )
            yr, yi = self._run(x_r, x_i, ph)
            return jnp.stack([yr, yi], axis=-1)
        t = x.shape[-1]
        assert t % self.p_in == 0, f"block length {t} not a multiple of {self.p_in}"
        b = t // self.p_in
        ph = period_phases(
            self.f_offsets, self.fs, self.sdrclk, self.lo_wrap, b,
            self._period_cursor if period0 is None else period0,
        )
        if period0 is None:
            self._period_cursor += b
        if isinstance(x, np.ndarray):
            x_r = np.ascontiguousarray(x.real, dtype=np.float32).reshape(b, self.p_in)
            if self.real_input or not np.iscomplexobj(x):
                x_i = np.zeros_like(x_r)
            else:
                x_i = np.ascontiguousarray(x.imag, dtype=np.float32).reshape(b, self.p_in)
            x_r, x_i = jnp.asarray(x_r), jnp.asarray(x_i)
        else:
            x = jnp.asarray(x)
            if self.real_input or not jnp.iscomplexobj(x):
                x_r = x.real.astype(jnp.float32).reshape(b, self.p_in)
                x_i = jnp.zeros_like(x_r)
            else:
                x_r = x.real.astype(jnp.float32).reshape(b, self.p_in)
                x_i = x.imag.astype(jnp.float32).reshape(b, self.p_in)
        yr, yi = self._run(x_r, x_i, ph)
        return jnp.stack([yr, yi], axis=-1)

    def _run(self, x_r, x_i, ph):
        if self.impl == "pfb":
            return _channelize_pfb_jit(
                x_r, x_i, self.qr_tables(False)[2],
                self._pfb_dfa, self._pfb_tw, self._pfb_dfb, self._pfb_bins,
                self._pfb_a, self._pfb_b, compute=self.compute,
            )
        if self.impl == "dft":
            # lo_wrap=True: the per-period phase is exactly 1, so ph drops
            return _channelize_dft_qr_jit(
                x_r, x_i, *self.qr_tables(False),
                compute=self.compute,
            )
        ph_r = jnp.asarray(np.ascontiguousarray(ph.real))
        ph_i = jnp.asarray(np.ascontiguousarray(ph.imag))
        if self.filter_mode == "fir":
            return _channelize_fir_jit(
                x_r, x_i, self._lo_r, self._lo_i, ph_r, ph_i,
                self._a_fir, self._fir_pad, compute=self.compute,
            )
        return _channelize_jit(
            x_r, x_i, self._lo_r, self._lo_i, ph_r, ph_i, self._a,
            compute=self.compute,
        )

    def qr_tables(self, split: bool) -> tuple:
        """(w_r, w_i, a2) device constants for the gather-free residue
        contraction (dft_qr_tables), built LAZILY per layout: split=True
        is the cu8 split-phase ingest layout, False the sample order.
        Any one run uses exactly one layout, and a band-scale a2 is tens
        of MB of device memory — building both eagerly doubled that for
        nothing."""
        cached = self._qr_cache.get(split)
        if cached is None:
            wq, a2 = dft_qr_tables(self.f_offsets, self.fs, self.sdrclk,
                                   split)
            cached = (jnp.asarray(np.ascontiguousarray(wq.real)),
                      jnp.asarray(np.ascontiguousarray(wq.imag)),
                      jnp.asarray(a2))
            self._qr_cache[split] = cached
        return cached

    def reset(self) -> None:
        self._period_cursor = 0
