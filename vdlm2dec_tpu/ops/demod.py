"""Vectorised D8PSK sync search + burst demodulation.

Re-expresses the reference's per-sample state machine (demodD8psk,
d8psk.c:232-333) as block-parallel array programs:

  * polyphase matched filter (filteredphase, d8psk.c:219-230) -> one
    batched 17-tap complex FIR per polyphase branch;
  * sync metric (d8psk.c:241-291): computed at *every* half-symbol position
    in parallel — unwrap via cumulative +-2pi steps, closed-form LS slope,
    residual energy;
  * trigger rule (d8psk.c:292): local minimum below 4.0 via the same
    perr/p2err hysteresis, evaluated vectorially;
  * per-candidate burst demod: gather a max-length symbol window, matched
    filter at the recovered timing phase, differential phase with CFO
    correction, Gray soft bits (d8psk.c:314-332, 211-217), soft descramble.

The candidate set is a superset of the reference's (the reference suspends
sync search while decoding a burst); overlapping candidates are filtered
greedily after header decode (pipeline.py), reproducing the serial decoder's
first-trigger-wins behaviour.
"""
from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import (
    GRAY_TABLES,
    KEYSTREAM,
    MBUFLEN,
    MFLT,
    POLYPHASE,
    SYNC_PHASES,
    SYNC_THRESHOLD,
)

TWO_PI = 2.0 * math.pi
PI = math.pi

# taps for trigger-time filteredphase with clk0 in 0..12 (clk0 = round(of),
# of in (4,12]); row c: mflt[c + 4j], zero-padded
_EXT_TAPS = np.zeros((13, MBUFLEN), dtype=np.float32)
for _c in range(13):
    _t = MFLT[_c::4]
    _EXT_TAPS[_c, : len(_t)] = _t

_POLY32 = POLYPHASE.astype(np.float32)           # (4, 17)
_GRAY32 = GRAY_TABLES.astype(np.float32)         # (3, 257)
# Gray soft values split into two bf16 parts (hi + residual) so the
# one-hot matmul lookup (used in place of a dynamic gather of (M, ms)
# soft bits) is exact to ~1e-5 relative
_GRAY_HI = GRAY_TABLES.T.astype(np.float32)      # (257, 3)
_SW32 = SYNC_PHASES.astype(np.float32)           # (17,)
_KS = KEYSTREAM.astype(np.bool_)                 # (MAX_BURST_BITS,)


def _pick_column(sel: jnp.ndarray, col: jnp.ndarray) -> jnp.ndarray:
    """sel (M, K, 8, 2), col (M,) in [0, 8) -> sel[m, :, col[m], :].

    A masked sum with one nonzero term: exact (x + 0 == x), and no dot
    that a GPU could run in TF32."""
    hit = jnp.arange(8)[None, :] == col[:, None]             # (M, 8)
    return jnp.sum(jnp.where(hit[:, None, :, None], sel, 0.0), axis=2)


def _gray_soft(gi: jnp.ndarray) -> jnp.ndarray:
    """(..., ) Gray indices in [0, 256] -> (..., 3) soft bits via a
    one-hot matmul over the 257-entry table (two bf16 parts, exact to
    ~1e-5 — far below the soft slicer's sensitivity)."""
    g = jnp.asarray(_GRAY_HI)                    # (257, 3) f32
    hi = g.astype(jnp.bfloat16)
    lo = (g - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    oh = (gi[..., None] == jnp.arange(257, dtype=gi.dtype)).astype(
        jnp.bfloat16)
    flat = oh.reshape(-1, 257)
    v = (jnp.dot(flat, hi, preferred_element_type=jnp.float32)
         + jnp.dot(flat, lo, preferred_element_type=jnp.float32))
    return v.reshape(gi.shape + (3,))

# LS slope normaliser: sum over l of (l-8)^2 = 408 (d8psk.c:283)
_SLOPE_NORM = 408.0


def pack_complex(x: np.ndarray) -> np.ndarray:
    """Host complex -> (..., 2) f32 re/im planes (device convention)."""
    return np.stack(
        [np.asarray(x.real, np.float32), np.asarray(x.imag, np.float32)], axis=-1
    )


def polyphase_filter(y: jnp.ndarray, compute: str = "f32") -> jnp.ndarray:
    """(C, T, 2) re/im -> (C, 4, T, 2) filtered, all 4 polyphases.

    Output index t corresponds to the filter applied to y[t-16 .. t]
    (the ring ends at sample t); entries t < 16 use zero history.
    The whole device pipeline is complex-free: filtering acts on the re/im
    planes independently.

    Implemented as 17 static-slice multiply-adds (out[t] = sum_j
    y[t-16+j] * taps[:, j], matching filteredphase d8psk.c:219-230) —
    one fused elementwise pass, always f32 (no matmul, so `compute`
    has nothing to select and is accepted for a uniform signature)."""
    del compute
    c, t, _ = y.shape
    yp = jnp.pad(y, ((0, 0), (16, 0), (0, 0))).astype(jnp.float32)
    acc = [None] * 4
    for j in range(17):
        seg = yp[:, j : j + t, :]
        for phi in range(4):
            term = _POLY32[phi, j] * seg
            acc[phi] = term if acc[phi] is None else acc[phi] + term
    return jnp.stack(acc, axis=1)                 # (C, 4, T, 2)


def polyphase_filter0(y: jnp.ndarray, compute: str = "f32") -> jnp.ndarray:
    """(C, T, 2) re/im -> (C, T, 2): polyphase BRANCH 0 only.

    The sync metric consumes only the branch-0 filter output (the ring
    ending at each sample), so the sync path can skip 3/4 of the filter
    work and never materialize the (C, 4, T, 2) tensor — used by
    sync_impl="stream" where the demod filters its own windows inline.
    Same 17-slice multiply-add form as polyphase_filter."""
    del compute
    c, t, _ = y.shape
    yp = jnp.pad(y, ((0, 0), (16, 0), (0, 0))).astype(jnp.float32)
    acc = None
    for j in range(17):
        term = _POLY32[0, j] * yp[:, j : j + t, :]
        acc = term if acc is None else acc + term
    return acc


def phase_of(f: jnp.ndarray) -> jnp.ndarray:
    """atan2 phase of a (..., 2) re/im array."""
    return jnp.arctan2(f[..., 1], f[..., 0])


def _sync_scan_core(pad: jnp.ndarray, t: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sync metric over a left-padded phase block: pad (C, 128+t) -> the
    (err, fr) of the t positions whose windows end inside the block.

    Unrolled running-sum formulation: the 17 window phases stream through
    as static slices of pad while S0 = sum(pr), S1 = sum(pr*(k-8)),
    S2 = sum(pr^2) accumulate, then the LS residual comes out closed-form
    (err = S2 - S0^2/17 - S1^2/408, fr = S1/408 — exact because
    sum(k-8) = 0 over k=0..16).  A single fused elementwise pass over 17
    slice reads: no (C, 17, T) window tensor or same-size temporaries
    go through device memory.
    Same unwrap/metric semantics as filteredphase+demodD8psk
    (d8psk.c:241-291), oracle-tested."""
    sw = _SW32
    a0 = pad[:, 0:t] - sw[0]
    # accumulate pr RELATIVE to the window's first phase: err/fr are
    # exactly shift-invariant, and small sums avoid the catastrophic
    # S2 - S0^2/17 cancellation a large common phase would cause in f32
    p_prev = a0
    cum = jnp.zeros_like(a0)
    s0 = jnp.zeros_like(a0)
    s1 = jnp.zeros_like(a0)
    s2 = jnp.zeros_like(a0)
    for k in range(1, 17):
        pk = pad[:, 8 * k : 8 * k + t] - sw[k]
        pd = pk - p_prev
        cum = cum + jnp.where(pd > PI, -TWO_PI,
                              jnp.where(pd < -PI, TWO_PI, 0.0))
        pr = (pk - a0) + cum
        s0 = s0 + pr
        s1 = s1 + (k - 8.0) * pr
        s2 = s2 + pr * pr
        p_prev = pk
    fr = s1 / _SLOPE_NORM
    err = s2 - s0 * s0 * (1.0 / 17.0) - s1 * fr
    return err, fr


# past this element count, chunk the time axis through lax.map so peak
# memory and the size of the compiled program stay bounded
_SYNC_DENSE_LIMIT = 8_000_000
_SYNC_CHUNK = 8192


def _prefix_count(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix sum of a (C, T) 0/1 int32 stream via a two-level
    block decomposition: one (128, 128) lower-triangular matmul for the
    intra-block prefixes + a tiny cumsum of block totals, in place of a
    log-depth cumsum over the long axis.  Exact: counts stay far below
    2^24 (f32 integer range)."""
    c, t = x.shape
    blk = 128
    nb = -(-t // blk)
    xp = jnp.pad(x, ((0, 0), (0, nb * blk - t))).astype(jnp.float32)
    xb = xp.reshape(c, nb, blk)
    tri = jnp.tril(jnp.ones((blk, blk), jnp.float32)).T   # [i, j] = i <= j
    # DEFAULT allows TF32: exact here, 0/1 operands and sums <= 128
    intra = jnp.einsum("cbi,ij->cbj", xb, tri,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.DEFAULT)
    tot = intra[:, :, -1]
    offs = jnp.cumsum(tot, axis=1) - tot                  # exclusive
    out = (intra + offs[:, :, None]).astype(jnp.int32)
    return out.reshape(c, nb * blk)[:, :t]


def sync_scan(p0: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sync residual + slope at every position.

    p0: (C, T) phase of polyphase-0 filter output.
    Returns (err, fr): (C, T) each; position t uses the 17 phases at
    t-128, t-120, ..., t (symbol stride 8), i.e. the window *ending* at t.
    Entries with t < 128 are garbage (caller masks).
    """
    c, t = p0.shape
    pad = jnp.pad(p0, ((0, 0), (128, 0)))
    if c * t <= _SYNC_DENSE_LIMIT:
        return _sync_scan_core(pad, t)
    # chunked: identical math per window, sequenced over time chunks
    n_chunk = -(-t // _SYNC_CHUNK)
    pad = jnp.pad(pad, ((0, 0), (0, n_chunk * _SYNC_CHUNK - t)))
    starts = jnp.arange(n_chunk) * _SYNC_CHUNK
    win_idx = starts[:, None] + jnp.arange(128 + _SYNC_CHUNK)[None, :]
    wins = pad[:, win_idx].transpose(1, 0, 2)      # (n_chunk, C, 128+chunk)
    err, fr = jax.lax.map(
        lambda w: _sync_scan_core(w, _SYNC_CHUNK), wins
    )                                              # (n_chunk, C, chunk)
    err = err.transpose(1, 0, 2).reshape(c, -1)[:, :t]
    fr = fr.transpose(1, 0, 2).reshape(c, -1)[:, :t]
    return err, fr


def find_triggers(
    err: jnp.ndarray,
    fr: jnp.ndarray,
    max_candidates: int,
    first_valid: int = 150,
    threshold: float = SYNC_THRESHOLD,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Earliest max_candidates trigger positions per channel.

    The reference evaluates the metric every 2nd decimated sample (odd t with
    our indexing: first metric after 2 samples) and fires when the previous
    metric was below threshold and the current one increased (d8psk.c:292).

    Returns (t0, of, df, valid, q): each (C, K).
      t0: decimated-sample index of the trigger (phase consumed at t0)
      of: parabolic timing offset (quarter-sample units, d8psk.c:303-305)
      df: frequency offset = slope at the *previous* position (pfr)
      q:  the sub-threshold sync residual the trigger fired on (perr at
          t0-2) — real preambles sit far below the 4.0 threshold while
          noise triggers hover just under it, so q ranks candidates for
          decode-slot compaction under pressure (r5: the earliest-first
          key let junk evict late real bursts once traffic densified)
    """
    c, t = err.shape
    tt = jnp.arange(t)
    metric_pos = (tt % 2 == 1) & (tt >= first_valid)
    e0 = err
    e1 = jnp.pad(err, ((0, 0), (2, 0)))[:, :t]      # err at t-2 (perr)
    e2 = jnp.pad(err, ((0, 0), (4, 0)))[:, :t]      # err at t-4 (p2err)
    f1 = jnp.pad(fr, ((0, 0), (2, 0)))[:, :t]       # fr at t-2  (pfr)
    trig = metric_pos[None, :] & (e1 < threshold) & (e0 > e1)
    # suppress re-triggers: the serial decoder leaves WSYNC at the first
    # trigger of a preamble, so later local minima within one sync window
    # (17 symbols = 136 samples) never fire.  Windowed-OR via prefix
    # counts (two-level matmul decomposition — see _prefix_count).
    cnt = _prefix_count(trig.astype(jnp.int32))
    prev = cnt - trig.astype(jnp.int32)                   # count up to t-1
    prev_far = jnp.pad(cnt, ((0, 0), (137, 0)))[:, :t]    # count up to t-137
    recent = (prev - prev_far) > 0
    trig = trig & ~recent
    # earliest K triggers: surviving triggers are >136 samples apart (the
    # suppression window), so every 128-sample block holds AT MOST ONE —
    # a per-block min-reduce compacts (C, T) to (C, T/128) exactly, and
    # the top_k runs on that instead of on the whole stream.
    pos = jnp.where(trig, tt[None, :], t + 1)
    blk = 128
    nb = -(-t // blk)
    posb = jnp.pad(pos, ((0, 0), (0, nb * blk - t)),
                   constant_values=t + 1)
    best = posb.reshape(c, nb, blk).min(axis=2)           # (C, nb)
    k_eff = min(max_candidates, best.shape[1])
    topv, _ = jax.lax.top_k(-best, k_eff)
    t0 = -topv            # descending neg -> ascending positions
    if k_eff < max_candidates:
        t0 = jnp.pad(t0, ((0, 0), (0, max_candidates - k_eff)),
                     constant_values=t + 1)
    valid = t0 <= t
    t0c = jnp.minimum(t0, t - 1)
    ge2 = jnp.take_along_axis(e2, t0c, axis=1)
    ge1 = jnp.take_along_axis(e1, t0c, axis=1)
    ge0 = jnp.take_along_axis(e0, t0c, axis=1)
    df = jnp.take_along_axis(f1, t0c, axis=1)
    of = 4.0 * (ge2 - 4.0 * ge1 + 3.0 * ge0) / (ge2 - 2.0 * ge1 + ge0)
    return t0c, of, df, valid, ge1


@functools.partial(jax.jit, static_argnames=("max_symbols",))
def demod_candidates_flat(
    y: jnp.ndarray,
    chan: jnp.ndarray,
    t0: jnp.ndarray,
    of: jnp.ndarray,
    df: jnp.ndarray,
    max_symbols: int,
    f_all: jnp.ndarray,
) -> jnp.ndarray:
    """Demodulate a FLAT candidate list (M,) with per-candidate channel ids.

    Same math as demod_candidates, but candidates are pre-compacted across
    channels so downstream stages scale with real traffic, not with
    channels x sync-slots.
    """
    c, t, _ = y.shape
    overrun = 7 + 8 * max_symbols
    fpad = jnp.pad(f_all, ((0, 0), (0, 0), (0, overrun), (0, 0)))
    ypad = jnp.pad(y, ((0, 0), (16, 0), (0, 0)))

    def one(ci, t0c, ofc, dfc):
        clk0 = jnp.clip(jnp.floor(ofc + 0.5), 0, 12).astype(jnp.int32)
        win = jax.lax.dynamic_slice(ypad, (ci, t0c, 0), (1, 17, 2))[0]
        taps1 = jnp.asarray(_EXT_TAPS)[clk0]
        s1v = jnp.sum(win * taps1[:, None], axis=0)
        p1 = jnp.arctan2(s1v[1], s1v[0])
        phi = clk0 % 4
        s1 = (32 - clk0 + 3) // 4
        pos = t0c + s1 + 8 * jnp.arange(max_symbols)
        f = fpad[ci, phi, pos]
        p = jnp.arctan2(f[:, 1], f[:, 0])
        pprev = jnp.concatenate([p1[None].astype(p.dtype), p[:-1]])
        d = (p - pprev) - dfc
        d = jnp.where(d > PI, d - TWO_PI, d)
        d = jnp.where(d < -PI, d + TWO_PI, d)
        gi = jnp.clip(jnp.floor(128.0 * d / PI + 128.0 + 0.5), 0, 256).astype(jnp.int32)
        g = jnp.asarray(_GRAY32)
        soft = g[:, gi].T.reshape(-1)
        ks = jnp.asarray(_KS[: soft.shape[0]])
        return jnp.where(ks, 1.0 - soft, soft)

    return jax.vmap(one)(chan, t0, of, df)


@functools.partial(jax.jit, static_argnames=("max_symbols",))
def demod_candidates_inline(
    y: jnp.ndarray,
    chan: jnp.ndarray,
    t0: jnp.ndarray,
    of: jnp.ndarray,
    df: jnp.ndarray,
    max_symbols: int,
) -> jnp.ndarray:
    """demod_candidates_flat without the materialized filter tensor and
    without big dynamic gathers:

      * each candidate's contiguous y window comes from ONE slab gather
        (M start indices, contiguous (win, 2) slices);
      * the 17-tap matched filter at the candidate's polyphase runs as
        17 static-slice multiply-adds over the whole window (no (ms, 17)
        element gather);
      * symbol selection exploits s1 = (35-clk0)//4 in {5,6,7,8}: after
        reshaping the filtered window to 8-sample rows, the symbol
        stream is a 0/1 row shift (s1==8) plus an 8-way column select
        (_pick_column) — fully static indexing;
      * Gray soft bits come from the one-hot matmul lookup.

    Same products as filteredphase (d8psk.c:219-230) at exactly the
    symbol positions consumed (d8psk.c:317-328)."""
    c, t, _ = y.shape
    ms = max_symbols
    win_len = 8 * (ms + 4)          # covers s1 + 8*ms + 17, multiple of 8
    # left pad 16 (filter ring), right pad one full candidate window
    ypad = jnp.pad(y, ((0, 0), (16, win_len), (0, 0)))
    m = chan.shape[0]
    clk0 = jnp.clip(jnp.floor(of + 0.5), 0, 12).astype(jnp.int32)
    phi = clk0 % 4
    s1 = (32 - clk0 + 3) // 4                         # in {5,6,7,8}

    starts = jnp.stack([chan, t0], axis=1)            # (M, 2) into ypad
    w = jax.lax.gather(
        ypad, starts,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1, 2), collapsed_slice_dims=(0,),
            start_index_map=(0, 1)),
        slice_sizes=(1, win_len, 2),
        mode=jax.lax.GatherScatterMode.CLIP)          # (M, win_len, 2)

    # trigger-time filteredphase with the clk0-extended taps
    taps1 = jnp.asarray(_EXT_TAPS)[clk0]              # (M, MBUFLEN)
    # HIGHEST: a TF32 dot would round the filter inputs to 10 bits and
    # move the trigger-time phase p1 off the CPU/reference value
    s1v = jnp.einsum("mkp,mk->mp", w[:, : taps1.shape[1]], taps1,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    p1 = jnp.arctan2(s1v[:, 1], s1v[:, 0])

    # matched filter over the whole window at each candidate's polyphase
    tp = jnp.asarray(_POLY32)[phi]                    # (M, 17)
    l = win_len - 16
    f = None
    for j in range(17):
        term = tp[:, j, None, None] * w[:, j : j + l, :]
        f = term if f is None else f + term           # (M, L, 2)
    # f[m, t] = filter output at stream position t0 + t; symbols at
    # t = s1 + 8k.  L is a multiple of 8, so view 8-sample rows and
    # select (row k + [s1==8], column s1&7)
    fv = f.reshape(m, l // 8, 8, 2)
    base = fv[:, : ms + 1]                            # (M, ms+1, 8, 2)
    shift = (s1 == 8)
    sel = jnp.where(shift[:, None, None, None], base[:, 1:], base[:, :ms])
    sym = _pick_column(sel, s1 & 7)                   # (M, ms, 2)

    p = jnp.arctan2(sym[..., 1], sym[..., 0])
    pprev = jnp.concatenate([p1[:, None], p[:, :-1]], axis=1)
    d = (p - pprev) - df[:, None]
    d = jnp.where(d > PI, d - TWO_PI, d)
    d = jnp.where(d < -PI, d + TWO_PI, d)
    gi = jnp.clip(jnp.floor(128.0 * d / PI + 128.0 + 0.5),
                  0, 256).astype(jnp.int32)
    soft = _gray_soft(gi).reshape(m, -1)              # (M, ms*3)
    ks = jnp.asarray(_KS[: soft.shape[1]])
    return jnp.where(ks[None, :], 1.0 - soft, soft)
