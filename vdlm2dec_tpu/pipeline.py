"""End-to-end decode pipeline: wideband IQ -> decoded AVLC frames.

Device-resident stages (one jitted program):
  channelizer -> polyphase filter -> vectorised sync scan -> candidate
  trigger extraction -> batched burst demod -> header trellis -> block
  assembly -> vectorised RS FEC
Host stages (tiny, irregular):
  greedy overlap filtering (replicates the serial decoder's
  first-trigger-wins, since the reference suspends sync search during a
  burst) -> HDLC unstuff -> CRC -> AVLC/L5.

Streaming: long captures are processed in overlapping blocks; a candidate is
owned by the block whose core region contains its trigger.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from .constants import DEMOD_RATE, MAX_BURST_SYMBOLS, RS_K
from .golden.codec import Unstuffer, frame_crc_ok
from .ops.assembly import MAX_TX_BYTES, assemble_blocks
from .ops.channelizer import Channelizer
from .ops.demod import (
    find_triggers,
    pack_complex,
    phase_of,
    polyphase_filter,
    sync_scan,
)
from .ops.header import header_decode
from .ops.rs_fec import rs_decode_rows

TWO_PI = 2.0 * math.pi


@dataclass
class DecodedBurst:
    """A CRC-pending decoded burst (post-FEC), plus its valid frames."""
    channel: int
    t0: int                      # decimated-sample index of sync trigger
    time_s: float                # t0 / 84 kHz relative to stream start
    freq_hz: float               # RF channel frequency
    ppm: float                   # per-burst frequency-offset estimate
    length_bits: int
    nbrow: int
    nlbyte: int
    block: np.ndarray            # (nbrow, 255) RS-corrected
    rs_counts: list[int]
    frames: list[np.ndarray] = field(default_factory=list)  # incl. flags


@dataclass
class PipelineConfig:
    freqs_hz: list[float]                  # RF channel frequencies
    fs: int = 2_000_000                    # wideband input rate
    fc_hz: float | None = None             # center frequency (None: auto)
    real_input: bool = False               # airspy-style real capture
    lo_wrap: bool = True                   # reference's wrapped LO table
    max_candidates: int = 32               # sync candidates per channel/block
    max_symbols: int = MAX_BURST_SYMBOLS   # burst demod window
    sdrclk: int | None = None
    mesh: object | None = None             # jax.sharding.Mesh for multi-card
    max_out: int | None = None             # decode slots per block (None: auto)
    filter_mode: str = "boxcar"            # "fir": >60 dB adjacent-channel
                                           # rejection (beats the reference's
                                           # ~1 dB boxcar); boxcar = parity
    chan_impl: str = "auto"                # "auto": residue-space "dft"
                                           # channelizer when the plan is
                                           # eligible (25 kHz-raster
                                           # offsets, wrapped-LO boxcar —
                                           # every real VDL plan), else
                                           # dense "matmul".  dft computes
                                           # identical products in 25/84
                                           # the FLOPs with no (C,B,P_in)
                                           # intermediate; "pfb" does
                                           # O(sqrt(tbl)) per output for
                                           # hundreds of channels
    compute: str = "f32"                   # "bf16": channelizer matmuls on
                                           # bfloat16 operands w/ f32 accum;
                                           # header/RS/CRC stay exact —
                                           # frame-parity tested
    sync_impl: str = "stream"              # "stream": branch-0-only filter
                                           # + running-sum sync core +
                                           # batched inline demod (the
                                           # (C,4,T,2) polyphase tensor is
                                           # never built); "xla": full
                                           # polyphase tensor + gather
                                           # demod.  Frame-parity tested.

    def resolved_sdrclk(self) -> int:
        return self.sdrclk if self.sdrclk is not None else self.fs // 4000


# Packed-result layout (one uint8 row per surviving candidate):
#   [0:2040)    burst block (8 rows x 255 bytes)
#   [2040:2048) rs counts per row, int8 (count+1 so -1 fits unsigned)
#   [2048:2096) 12 int32 little-endian meta words:
#               chan, t0, length, nbrow, nlbyte, consumed, live,
#               of_bits, df_bits, then block-wide stats carried in row 0
#               only (zero elsewhere so concatenated shard buffers sum
#               correctly): n_sync_valid, n_header_reject, n_overflow
#               (triggers dropped because they exceeded max_out slots)
PACKED_ROW_BYTES = 2040 + 8 + 48

# above this (channels x samples) element count, the per-candidate demod
# vmap runs in lax.map chunks of 32, which bounds the size of the program
# XLA has to compile at whole-band block shapes
DEMOD_CHUNK_GATE = 8_000_000


def _device_decode_packed(y, max_candidates: int, max_symbols: int,
                          max_out: int, chan_base=0,
                          core_start: int = 0, core_len: int = 0,
                          compute: str = "f32", sync_impl: str = "xla",
                          probe_stage: str | None = None):
    """Packed decode with EARLY candidate compaction.

    Sync scan produces (C, K) trigger slots; real traffic is far sparser,
    so candidates compact to a flat top-max_out list (by validity, then
    trigger time) BEFORE the expensive per-candidate stages — demod, header,
    assembly and RS then scale with max_out, not C*K.

    core_start/core_len (nonzero in the sharded path): only triggers inside
    the core region are owned by this block/shard; packed t0 is shifted to
    be core-relative.

    probe_stage (static, measurement only — tools/device_stages.py):
    truncate the program after the named stage ("filter", "sync",
    "triggers", "demod", "header", "assemble") and return that stage's
    tensor, so cumulative device-resident timings of the REAL program
    localize where chip time goes.  None = the full packed decode.
    """
    from .ops.demod import demod_candidates_flat, demod_candidates_inline

    if sync_impl == "stream":
        # streaming sync: the metric needs only polyphase BRANCH 0 (the
        # ring ending at each sample), so filter one branch — (C, T, 2),
        # a quarter of the full tensor — feed the running-sum sync core,
        # and let the demod filter its own windows inline.  y is read
        # once and no (C, 4, T, 2) tensor exists.
        from .ops.demod import polyphase_filter0

        f = None
        f0 = polyphase_filter0(y, compute=compute)
        if probe_stage == "filter":
            return f0
        err, fr = sync_scan(phase_of(f0))
    else:
        f = polyphase_filter(y, compute=compute)
        if probe_stage == "filter":
            return f
        p0 = phase_of(f[:, 0])
        err, fr = sync_scan(p0)
    if probe_stage == "sync":
        return err + fr
    # materialize err/fr ONCE: find_triggers reads them at three shifted
    # offsets (t, t-2, t-4) and without the fence XLA may rematerialize
    # the whole 17-slice sync core inside each consumer fusion
    err, fr = jax.lax.optimization_barrier((err, fr))
    t0, of, df, valid, q = find_triggers(err, fr, max_candidates)
    if probe_stage == "triggers":
        return (t0.astype(jnp.float32) + of + df
                + valid.astype(jnp.float32) + q)
    if core_len:
        valid = valid & (t0 >= core_start) & (t0 < core_start + core_len)

    c, k = t0.shape
    n = c * k
    m = min(max_out, n)
    # compact by SYNC QUALITY, not trigger time: under slot pressure the
    # best-synced candidates (real preambles, q << 4.0) survive and junk
    # (q ~ 4.0) drops — time-ordered compaction let noise triggers evict
    # late real bursts once the r5 stimulus densified (band 40/115,
    # 2000ch 27/34 recall failures caught by the bench gates)
    key = jnp.where(valid.reshape(n), q.reshape(n), jnp.float32(np.inf))
    order = jnp.argsort(key)[:m]
    chan = (order // k).astype(jnp.int32)
    t0s = t0.reshape(n)[order]
    ofs = of.reshape(n)[order]
    dfs = df.reshape(n)[order]
    live = valid.reshape(n)[order]

    # fusion fence: without it XLA tries to rematerialize the channelizer/
    # filter producers inside the per-candidate gather loops, which blows
    # the compiler at whole-band shapes (hundreds of channels)
    if f is None:
        y = jax.lax.optimization_barrier(y)
        demod = lambda ch_, t_, o_, d_: demod_candidates_inline(
            y, ch_, t_, o_, d_, max_symbols)
    else:
        y, f = jax.lax.optimization_barrier((y, f))
        demod = lambda ch_, t_, o_, d_: demod_candidates_flat(
            y, ch_, t_, o_, d_, max_symbols, f)
    big = y.shape[0] * y.shape[1] > DEMOD_CHUNK_GATE
    if big and m > 32 and m % 32 == 0:
        # chunk the candidate vmap through lax.map: the all-at-once
        # gather over a near-GB filter tensor makes XLA's compile time
        # explode past (760, ~21000)-sample blocks
        def _chunk(a):
            return demod(a[0], a[1], a[2], a[3])
        soft = jax.lax.map(
            _chunk, (chan.reshape(-1, 32), t0s.reshape(-1, 32),
                     ofs.reshape(-1, 32), dfs.reshape(-1, 32))
        ).reshape(m, -1)
    else:
        soft = demod(chan, t0s, ofs, dfs)
    if probe_stage == "demod":
        return soft
    length, nbrow, nlbyte, ok = header_decode(soft[:, :25])
    if probe_stage == "header":
        return (length + nbrow + nlbyte).astype(jnp.float32) \
            + ok.astype(jnp.float32)
    need = 8 * MAX_TX_BYTES
    data_soft = soft[:, 25 : 25 + need]
    if data_soft.shape[1] < need:
        data_soft = jnp.pad(data_soft, ((0, 0), (0, need - data_soft.shape[1])))
    blocks, consumed = assemble_blocks(data_soft, nbrow, nlbyte)
    if probe_stage == "assemble":
        return blocks.astype(jnp.float32)

    rows = blocks.reshape(m * 8, 255)
    ridx = jnp.tile(jnp.arange(8), m).reshape(m, 8)
    is_last = ridx == (nbrow[:, None] - 1)
    cls_last = jnp.where(
        nlbyte[:, None] <= 30, 2, jnp.where(nlbyte[:, None] <= 67, 1, 0)
    )
    eras_class = jnp.where(is_last, cls_last, 0).reshape(-1)
    fixed, counts = rs_decode_rows(rows, eras_class)

    # block-wide stage counters, carried in row 0 only so buffers
    # concatenated across shards still sum correctly on the host
    n_sync_valid = jnp.sum(valid.astype(jnp.int32))
    n_header_reject = jnp.sum((live & ~ok).astype(jnp.int32))
    first = (jnp.arange(m) == 0).astype(jnp.int32)
    live = live & ok
    meta = jnp.stack(
        [
            chan + chan_base,
            (t0s - core_start).astype(jnp.int32),
            length.astype(jnp.int32),
            nbrow.astype(jnp.int32),
            nlbyte.astype(jnp.int32),
            consumed.astype(jnp.int32),
            live.astype(jnp.int32),
            jax.lax.bitcast_convert_type(ofs.astype(jnp.float32), jnp.int32),
            jax.lax.bitcast_convert_type(dfs.astype(jnp.float32), jnp.int32),
            first * n_sync_valid,
            first * n_header_reject,
            first * jnp.maximum(n_sync_valid - m, 0),
        ],
        axis=1,
    )
    meta_u8 = jax.lax.bitcast_convert_type(meta, jnp.uint8).reshape(m, 48)
    rs8 = (counts.reshape(m, 8).astype(jnp.int32) + 1).astype(jnp.uint8)
    return jnp.concatenate([fixed.reshape(m, 8 * 255), rs8, meta_u8], axis=1)


_device_decode_packed_jit = jax.jit(
    _device_decode_packed,
    static_argnames=("max_candidates", "max_symbols", "max_out",
                     "core_start", "core_len", "compute", "sync_impl",
                     "probe_stage"),
)


def _raw_to_planes(raw, fmt: str, dc_offset, p_in: int):
    """Native raw samples -> (x_r, x_i) float32 planes of shape (B, P_in).

    Shared by every fused-ingest wrapper.  cu8 subtracts the rtl_sdr DC
    offset (rtl.c:274-295); f32real is the airspy half-rate real capture
    (imag=0 — the fs/4 arrangement is baked into the LO offsets).

    The integer formats deinterleave by BITCAST, not stride slicing:
    adjacent (re, im) u8 pairs ARE one u16 word (i16 pairs one i32), so
    shift/mask is pure elementwise work on a dense layout instead of a
    stride-2 relayout of the whole converted tensor."""
    if fmt == "f32real":
        x_r = raw.astype(jnp.float32).reshape(-1, p_in)
        return x_r, jnp.zeros_like(x_r)
    if fmt == "cu8":
        u = jax.lax.bitcast_convert_type(
            raw.reshape(-1, 2), jnp.uint16).astype(jnp.int32)
        x_r = (u & 0xFF).astype(jnp.float32) - dc_offset
        x_i = (u >> 8).astype(jnp.float32) - dc_offset
        return x_r.reshape(-1, p_in), x_i.reshape(-1, p_in)
    if fmt == "cs16":
        u = jax.lax.bitcast_convert_type(raw.reshape(-1, 2), jnp.int32)
        x_r = ((u << 16) >> 16).astype(jnp.float32)   # arithmetic shift
        x_i = (u >> 16).astype(jnp.float32)           # sign-extends
        return x_r.reshape(-1, p_in), x_i.reshape(-1, p_in)
    x = raw.astype(jnp.float32)
    return x[0::2].reshape(-1, p_in), x[1::2].reshape(-1, p_in)


def _raw_to_planes_split(raw, dc_offset, p_in: int):
    """cu8 -> (x_r, x_i) f32 planes in SPLIT-PHASE layout
    [even samples | odd samples] per period row.

    Bitcasting FOUR u8s to one native i32 (re0,im0,re1,im1) keeps every
    op 32-bit (no u16 intermediate to unpack).  The layout permutation
    is absorbed by the consumer's contraction tables
    (ops.channelizer.dft_qr_tables with split=True) — never
    materialized."""
    w = jax.lax.bitcast_convert_type(raw.reshape(-1, 4), jnp.int32)
    re0 = (w & 0xFF).astype(jnp.float32) - dc_offset
    im0 = ((w >> 8) & 0xFF).astype(jnp.float32) - dc_offset
    re1 = ((w >> 16) & 0xFF).astype(jnp.float32) - dc_offset
    im1 = ((w >> 24) & 0xFF).astype(jnp.float32) - dc_offset
    h = p_in // 2
    x_r = jnp.concatenate([re0.reshape(-1, h), re1.reshape(-1, h)], axis=1)
    x_i = jnp.concatenate([im0.reshape(-1, h), im1.reshape(-1, h)], axis=1)
    return x_r, x_i


def _wideband_u8_decode(raw, lo_r, lo_i, ph_r, ph_i, a, dc_offset,
                        max_candidates: int, max_symbols: int, max_out: int,
                        fmt: str = "cu8",
                        core_start: int = 0, core_len: int = 0,
                        compute: str = "f32", sync_impl: str = "xla",
                        probe_stage: str | None = None):
    """Fused device program: raw wideband IQ -> packed candidates.

    Ships the capture's NATIVE sample format over the host link and
    converts on device — 2 bytes/sample for cu8 (the rtl_sdr format,
    rtl.c:274-295, incl. the -127.37 DC offset), 4 for cs16, 8 for cf32,
    4 for airspy f32real (half rate, imag=0; the fs/4 arrangement is baked
    into the LO offsets).  One dispatch, one fetch.
    """
    from .ops.channelizer import mm_mode

    p_in = lo_r.shape[1]
    c = lo_r.shape[0]
    x_r, x_i = _raw_to_planes(raw, fmt, dc_offset, p_in)
    mr = x_r[None] * lo_r[:, None, :] - x_i[None] * lo_i[:, None, :]
    mi = x_r[None] * lo_i[:, None, :] + x_i[None] * lo_r[:, None, :]
    zr = mr * ph_r[:, :, None] - mi * ph_i[:, :, None]
    zi = mr * ph_i[:, :, None] + mi * ph_r[:, :, None]
    dt, prec = mm_mode(compute)
    zr, zi, am = zr.astype(dt), zi.astype(dt), a.astype(dt)
    yr = jnp.einsum("cbn,nm->cbm", zr, am,
                    preferred_element_type=jnp.float32, precision=prec)
    yi = jnp.einsum("cbn,nm->cbm", zi, am,
                    preferred_element_type=jnp.float32, precision=prec)
    y = jnp.stack([yr.reshape(c, -1), yi.reshape(c, -1)], axis=-1)
    if probe_stage == "channelize":
        return y
    return _device_decode_packed(y, max_candidates, max_symbols, max_out,
                                 core_start=core_start, core_len=core_len,
                                 compute=compute, sync_impl=sync_impl,
                                 probe_stage=probe_stage)


_wideband_u8_decode_jit = jax.jit(
    _wideband_u8_decode,
    static_argnames=("max_candidates", "max_symbols", "max_out", "fmt", "core_start", "core_len", "compute",
                     "sync_impl", "probe_stage"),
)


def _wideband_raw_decode_dft(raw, w_r, w_i, a2, dc_offset,
                             p_in: int, max_candidates: int,
                             max_symbols: int, max_out: int,
                             fmt: str = "cu8",
                             core_start: int = 0, core_len: int = 0,
                             compute: str = "f32", sync_impl: str = "xla",
                             probe_stage: str | None = None):
    """Fused device program with the residue-space channelizer: native raw
    IQ -> batched (B, Q, tbl) x (Q, tbl, 84) contraction into residue
    space -> one (C, tbl) matmul -> decode.  Same products as the
    wrapped-LO mix+dump (see ops.channelizer.dft_qr_tables) but O(tbl)
    per output sample, no (C, B, P_in) intermediate and no gather — the
    path that scales to the whole band.

    For cu8 the split-phase ingest is used and the caller passes the
    split-layout (w, a2) tables (ch._qr_*_s)."""
    from .ops.channelizer import _channelize_dft_qr_jit

    if fmt == "cu8":
        x_r, x_i = _raw_to_planes_split(raw, dc_offset, p_in)
    else:
        x_r, x_i = _raw_to_planes(raw, fmt, dc_offset, p_in)
    yr, yi = _channelize_dft_qr_jit(x_r, x_i, w_r, w_i, a2,
                                    split=(fmt == "cu8"), compute=compute)
    # fence the residue-space contraction out of the sync-scan fusion:
    # fusing the channelizer into the sync consumers made XLA's compile
    # time explode on full-burst-window shapes (max_symbols 5456, T~380k)
    y = jax.lax.optimization_barrier(jnp.stack([yr, yi], axis=-1))
    if probe_stage == "channelize":
        return y
    return _device_decode_packed(y, max_candidates, max_symbols, max_out,
                                 core_start=core_start, core_len=core_len,
                                 compute=compute, sync_impl=sync_impl,
                                 probe_stage=probe_stage)


_wideband_raw_decode_dft_jit = jax.jit(
    _wideband_raw_decode_dft,
    static_argnames=("p_in", "max_candidates", "max_symbols", "max_out",
                     "fmt", "core_start", "core_len", "compute",
                     "sync_impl", "probe_stage"),
)


def _wideband_raw_decode_pfb(raw, a2, dfa, tw, dfb, bins,
                             dc_offset, a: int, b: int, p_in: int,
                             max_candidates: int, max_symbols: int,
                             max_out: int, fmt: str = "cu8",
                             core_start: int = 0, core_len: int = 0,
                             compute: str = "f32", sync_impl: str = "xla",
                             probe_stage: str | None = None):
    """Fused device program with the factorized-DFT filterbank channelizer
    (ops.channelizer.pfb_tables): all tbl raster bins via two small
    matmuls + twiddle, O(a+b) per output vs the dft impl's O(C)."""
    from .ops.channelizer import _channelize_pfb_jit

    # cu8: split-phase ingest + matching a2 table (see dft wrapper)
    if fmt == "cu8":
        x_r, x_i = _raw_to_planes_split(raw, dc_offset, p_in)
    else:
        x_r, x_i = _raw_to_planes(raw, fmt, dc_offset, p_in)
    yr, yi = _channelize_pfb_jit(x_r, x_i, a2, dfa, tw,
                                 dfb, bins, a, b, split=(fmt == "cu8"),
                                 compute=compute)
    # same compile-time fence as the dft wrapper (see there)
    y = jax.lax.optimization_barrier(jnp.stack([yr, yi], axis=-1))
    if probe_stage == "channelize":
        return y
    return _device_decode_packed(y, max_candidates, max_symbols, max_out,
                                 core_start=core_start, core_len=core_len,
                                 compute=compute, sync_impl=sync_impl,
                                 probe_stage=probe_stage)


_wideband_raw_decode_pfb_jit = jax.jit(
    _wideband_raw_decode_pfb,
    static_argnames=("a", "b", "p_in", "max_candidates", "max_symbols",
                     "max_out", "fmt", "core_start", "core_len", "compute",
                     "sync_impl", "probe_stage"),
)

# samples per LO period -> raw array items per period, and the neutral pad
# value for margins beyond the capture
RAW_FMT = {
    "cu8": (2, 127),
    "cs16": (2, 0),
    "cf32": (2, 0.0),
    "f32real": (1, 0.0),
}


def stream_geometry(p_in: int, p_out: int, fs: int, max_symbols: int,
                    block_seconds: float, align: int = 1
                    ) -> tuple[int, int, int, int]:
    """(lmarg_p, rmarg_p, core_p, total_p): streaming block geometry in
    channelizer periods, SHARED by every streaming path (single-host,
    live, multi-host) so block edges always agree.  Left halo covers the
    filter ring + sync window (>=160 decimated = parallel.sharding's
    HALO_LEFT); right halo one max burst window; total_p rounded up to
    align (mesh-shard granularity), absorbed into the right margin."""
    from .parallel.sharding import HALO_LEFT

    # the streaming left margin and the mesh shard halo must cover the
    # same history (filter ring + sync window + hysteresis) or block
    # edges would disagree between the streaming and sharded paths
    lmarg_p = -(-HALO_LEFT // p_out)
    rmarg_p = -(-(24 + 8 * max_symbols) // p_out)
    core_p = max(1, int(block_seconds * fs) // p_in)
    total_p = lmarg_p + core_p + rmarg_p
    total_p += (-total_p) % align
    rmarg_p = total_p - lmarg_p - core_p
    return lmarg_p, rmarg_p, core_p, total_p


def _dispatch_fused(pipe: "Pipeline", raw: np.ndarray, fmt: str,
                    core_start: int, core_len: int):
    """Dispatch one fused-ingest block (SHARED by the synchronous path and
    PipelinedDecoder): trims raw to the alignment, advances the LO cursor,
    and invokes the matmul or residue-space device program.  Returns the
    device buffer (not fetched)."""
    from .io.sdr import RTL_DC_OFFSET
    from .ops.channelizer import period_phases

    ch = pipe.channelizer
    per, _pad = RAW_FMT[fmt]
    t = len(raw) // per
    t -= t % ch.p_in
    b = t // ch.p_in
    ph = period_phases(
        ch.f_offsets, ch.fs, ch.sdrclk, ch.lo_wrap, b, ch._period_cursor
    )
    ch._period_cursor += b
    if ch.impl == "pfb":
        return _wideband_raw_decode_pfb_jit(
            jnp.asarray(raw[: per * t]),
            ch.qr_tables(fmt == "cu8")[2],
            ch._pfb_dfa, ch._pfb_tw, ch._pfb_dfb, ch._pfb_bins,
            jnp.float32(RTL_DC_OFFSET),
            ch._pfb_a, ch._pfb_b, ch.p_in,
            pipe.cfg.max_candidates,
            pipe.cfg.max_symbols,
            pipe._max_out(),
            fmt,
            core_start,
            core_len,
            compute=pipe.cfg.compute,
            sync_impl=pipe.cfg.sync_impl,
        )
    if ch.impl == "dft":
        return _wideband_raw_decode_dft_jit(
            jnp.asarray(raw[: per * t]),
            *ch.qr_tables(fmt == "cu8"),
            jnp.float32(RTL_DC_OFFSET),
            ch.p_in,
            pipe.cfg.max_candidates,
            pipe.cfg.max_symbols,
            pipe._max_out(),
            fmt,
            core_start,
            core_len,
            compute=pipe.cfg.compute,
            sync_impl=pipe.cfg.sync_impl,
        )
    return _wideband_u8_decode_jit(
        jnp.asarray(raw[: per * t]),
        ch._lo_r, ch._lo_i,
        jnp.asarray(np.ascontiguousarray(ph.real)),
        jnp.asarray(np.ascontiguousarray(ph.imag)),
        ch._a,
        jnp.float32(RTL_DC_OFFSET),
        pipe.cfg.max_candidates,
        pipe.cfg.max_symbols,
        pipe._max_out(),
        fmt,
        core_start,
        core_len,
        compute=pipe.cfg.compute,
        sync_impl=pipe.cfg.sync_impl,
    )


def make_device_probe(pipe: "Pipeline", raw: np.ndarray, fmt: str = "cu8",
                      probe_stage: str | None = None):
    """Chip-bound decode probe for benchmarking: returns (probe, raw_dev, t).

    probe(raw_dev, salts) runs len(salts) FULL decodes of the staged
    block inside one device program (lax.fori_loop, each iteration
    salt-perturbed so XLA cannot hoist the body) and returns a uint32
    checksum of every packed result, so only 4 bytes come back to the
    host: the device's own decode rate with upload, fetch and the host
    finisher out of the loop.  Time it with block_until_ready.

    The staged program is IDENTICAL in structure to _dispatch_fused's
    (same channelizer impl, sync impl, compute mode, packed layout); the
    LO phase cursor is pinned to 0 (repeat decodes of one block)."""
    from .io.sdr import RTL_DC_OFFSET
    from .ops.channelizer import period_phases

    ch = pipe.channelizer
    per, _pad = RAW_FMT[fmt]
    t = len(raw) // per
    t -= t % ch.p_in
    b = t // ch.p_in
    ph = period_phases(ch.f_offsets, ch.fs, ch.sdrclk, ch.lo_wrap, b, 0)
    ph_r = jnp.asarray(np.ascontiguousarray(ph.real))
    ph_i = jnp.asarray(np.ascontiguousarray(ph.imag))
    dc = jnp.float32(RTL_DC_OFFSET)
    mc, ms, mo = (pipe.cfg.max_candidates, pipe.cfg.max_symbols,
                  pipe._max_out())

    qr = None
    if ch.impl in ("dft", "pfb"):
        qr = ch.qr_tables(fmt == "cu8")

    def one(r):
        if ch.impl == "pfb":
            return _wideband_raw_decode_pfb(
                r, qr[2],
                ch._pfb_dfa, ch._pfb_tw, ch._pfb_dfb, ch._pfb_bins,
                dc, ch._pfb_a, ch._pfb_b, ch.p_in, mc, ms, mo, fmt,
                compute=pipe.cfg.compute, sync_impl=pipe.cfg.sync_impl,
                probe_stage=probe_stage)
        if ch.impl == "dft":
            return _wideband_raw_decode_dft(
                r, qr[0], qr[1], qr[2], dc, ch.p_in, mc, ms, mo, fmt,
                compute=pipe.cfg.compute, sync_impl=pipe.cfg.sync_impl,
                probe_stage=probe_stage)
        return _wideband_u8_decode(
            r, ch._lo_r, ch._lo_i, ph_r, ph_i, ch._a, dc, mc, ms, mo, fmt,
            compute=pipe.cfg.compute, sync_impl=pipe.cfg.sync_impl,
            probe_stage=probe_stage)

    @jax.jit
    def probe(raw_dev, salts):
        def body(i, acc):
            r = raw_dev.at[0].add(salts[i])
            packed = one(r)
            if probe_stage is not None:
                # stage truncation: reduce whatever tensor the stage
                # returned to one scalar (sum forces the whole stage)
                return acc + packed.astype(jnp.float32).sum().astype(
                    jnp.uint32)
            # checksum the bit-exact portions only: block bytes +
            # integer meta.  The float of/df meta words (7-8) round
            # differently across XLA program structures (a 1-trip loop
            # canonicalizes to the plain body; scan/fori bodies fuse
            # differently), so including them would make the checksum
            # compare program layout, not decode output
            return (acc + packed[:, :2048].astype(jnp.uint32).sum()
                    + packed[:, 2048:2076].astype(jnp.uint32).sum()
                    + packed[:, 2084:2096].astype(jnp.uint32).sum())

        return jax.lax.fori_loop(0, salts.shape[0], body, jnp.uint32(0))

    raw_dev = jax.device_put(jnp.asarray(raw[: per * t]))
    return probe, raw_dev, t


def packed_stats(buf: np.ndarray) -> dict:
    """Block-wide stage counters from a packed buffer (sums across shards)."""
    meta = np.ascontiguousarray(np.asarray(buf)[:, 2048:]).view(np.int32)
    return {
        "sync_candidates": int(meta[:, 9].sum()),
        "bursts_rejected_header": int(meta[:, 10].sum()),
        "candidates_overflow": int(meta[:, 11].sum()),
    }


def unpack_results(buf: np.ndarray) -> list[dict]:
    """Host-side unpack of _device_decode_packed rows -> candidate dicts."""
    out = []
    for row in np.ascontiguousarray(np.asarray(buf)):
        meta = row[2048:2096].copy().view(np.int32)
        live = int(meta[6])
        if not live:
            continue
        out.append(
            dict(
                chan=int(meta[0]),
                t0=int(meta[1]),
                length=int(meta[2]),
                nbrow=int(meta[3]),
                nlbyte=int(meta[4]),
                consumed=int(meta[5]),
                of=float(meta[7:8].view(np.float32)[0]),
                df=float(meta[8:9].view(np.float32)[0]),
                block=row[:2040].reshape(8, 255),
                rs_counts=row[2040:2048].copy().view(np.int8).astype(np.int32) - 1,
            )
        )
    return out


def burst_span_samples(consumed_bits: int, of: float) -> int:
    """Decimated samples from trigger to last consumed symbol."""
    clk0 = int(np.clip(np.floor(of + 0.5), 0, 12))
    s1 = (32 - clk0 + 3) // 4
    nsym = -(-(25 + consumed_bits) // 3)
    return s1 + 8 * (nsym - 1)


class Pipeline:
    def __init__(self, cfg: PipelineConfig):
        import dataclasses
        import threading

        # resolve auto fields (fc_hz, chan_impl) into a private copy: the
        # caller's cfg keeps its declared intent, so reusing it to build a
        # second Pipeline with edited freqs/fc re-resolves instead of
        # inheriting the first resolution (ADVICE r4)
        cfg = dataclasses.replace(cfg)
        self.cfg = cfg
        self.metrics = None              # optional PipelineMetrics sink
        self._overflow_warned = False
        self._metrics_lock = threading.Lock()
        self.sdrclk = cfg.resolved_sdrclk()
        if cfg.fc_hz is None:
            from .io.sdr import choose_fc

            cfg.fc_hz = choose_fc([int(f) for f in cfg.freqs_hz], cfg.fs)
        if cfg.real_input:
            f0 = cfg.fc_hz + cfg.fs / 4
        else:
            f0 = cfg.fc_hz
        self.f_offsets = [f - f0 for f in cfg.freqs_hz]
        if cfg.chan_impl == "auto":
            # resolve once so every later cfg.chan_impl branch (fused
            # ingest gate, wideband wrappers, checkpoint geometry) sees
            # the concrete implementation
            from .ops.channelizer import resolve_chan_impl

            cfg.chan_impl = resolve_chan_impl(
                self.f_offsets, cfg.fs, self.sdrclk, cfg.lo_wrap,
                cfg.filter_mode)
        self.channelizer = Channelizer(
            self.f_offsets,
            fs=cfg.fs,
            sdrclk=self.sdrclk,
            lo_wrap=cfg.lo_wrap,
            real_input=cfg.real_input,
            filter_mode=cfg.filter_mode,
            impl=cfg.chan_impl,
            compute=cfg.compute,
        )
        self._sharded = None
        if cfg.mesh is not None:
            from .parallel.sharding import ShardedDecoder

            self._sharded = ShardedDecoder(
                cfg.mesh,
                max_candidates=cfg.max_candidates,
                max_symbols=cfg.max_symbols,
            )

    # -- single-shot decode of a full capture --------------------------------
    def decode_wideband(self, x: np.ndarray) -> list[DecodedBurst]:
        p_in = self.channelizer.p_in
        t = len(x)
        if t % p_in:
            x = np.pad(x, (0, p_in - t % p_in))
        y = self.channelizer(x)          # (C, T84, 2) device array
        return self.decode_channels(y)

    def decode_channels(self, y: np.ndarray) -> list[DecodedBurst]:
        """y: (C, T) complex or (C, T, 2) re/im decimated 84 kHz streams."""
        if isinstance(y, np.ndarray) and np.iscomplexobj(y):
            y = pack_complex(y)
        if self.metrics is not None:
            self.metrics.decimated_samples += int(y.shape[0] * y.shape[1])
        if self._sharded is not None:
            cands = self._sharded.decode(y, observer=self._observe_packed)
        else:
            cands = self._decode_block(jnp.asarray(y, dtype=jnp.float32))
        return self._finish(cands, t_offset=0)

    def _decode_block(self, y: jnp.ndarray, core_start: int = 0,
                      core_len: int = 0) -> list[dict]:
        """Single-chip decode returning compacted host-side candidates.

        The packed path does ONE device->host fetch per block.
        core_start/core_len (streaming): only triggers inside the core
        region own slots and count in the stage counters, and t0 comes
        back core-relative.
        """
        import time as _time

        t_start = _time.perf_counter()
        buf = np.asarray(_device_decode_packed_jit(
            jnp.asarray(y, dtype=jnp.float32),
            self.cfg.max_candidates,
            self.cfg.max_symbols,
            self._max_out(),
            core_start=core_start,
            core_len=core_len,
            compute=self.cfg.compute,
            sync_impl=self.cfg.sync_impl,
        ))
        self._observe_packed(buf, _time.perf_counter() - t_start)
        return unpack_results(buf)

    def _observe_packed(self, buf: np.ndarray, device_s: float = 0.0) -> None:
        """Fold a packed buffer's on-device stage counters into metrics and
        surface candidate overflow (silent frame loss otherwise).  Called
        from fetch-worker threads too, hence the lock."""
        stats = packed_stats(buf)
        with self._metrics_lock:
            warn = stats["candidates_overflow"] and not self._overflow_warned
            if warn:
                self._overflow_warned = True
            m = self.metrics
            if m is not None:
                m.sync_candidates += stats["sync_candidates"]
                m.bursts_rejected_header += stats["bursts_rejected_header"]
                m.candidates_overflow += stats["candidates_overflow"]
                m.device_time_s += device_s
        if warn:
            import sys as _sys

            print(
                f"vdlm2t: WARNING: {stats['candidates_overflow']} sync "
                f"candidates dropped: decode slots exhausted "
                f"(max_out={self._max_out()}); raise max_out/max_candidates",
                file=_sys.stderr,
            )

    def _max_out(self) -> int:
        if self.cfg.max_out is not None:
            return min(self.cfg.max_out,
                       len(self.cfg.freqs_hz) * self.cfg.max_candidates)
        return min(len(self.cfg.freqs_hz) * self.cfg.max_candidates, 512)

    def decode_wideband_u8(self, raw: np.ndarray, fmt: str = "cu8",
                           core_start: int = 0,
                           core_len: int = 0) -> list[dict]:
        """Fused fast path: native-format raw IQ -> candidate dicts.

        The whole program (format convert + channelize + demod + FEC +
        packing) is one dispatch; only the capture's native bytes/sample
        cross the host->device link (2 for cu8, 4 cs16, 8 cf32,
        4 f32real).  core_start/core_len restrict ownership to the core
        region (streaming margins) on device; t0 returns core-relative.
        """
        import time as _time

        t_start = _time.perf_counter()
        buf = np.asarray(
            _dispatch_fused(self, raw, fmt, core_start, core_len))
        self._observe_packed(buf, _time.perf_counter() - t_start)
        return unpack_results(buf)

    # -- streaming -----------------------------------------------------------
    def core_raw_samples(self, block_seconds: float) -> int:
        """Raw wideband samples per streaming core block (exact; the
        checkpoint cursor advances in these units)."""
        p_in = self.channelizer.p_in
        return max(1, int(block_seconds * self.cfg.fs) // p_in) * p_in

    def stream_wideband(self, x, block_seconds: float = 4.0,
                        start_block: int = 0,
                        prev_end: dict[int, int] | None = None):
        """Decode a long capture in fixed-size overlapping blocks with
        CONSTANT memory: each core block's raw segment (core + halo margins)
        is sliced, channelized on device, and decoded — nothing is ever
        materialized at capture scale.  x: numpy array or io.sdr.CaptureReader
        (memmap-backed, so multi-GB captures stream from disk).

        Yields lists of DecodedBurst per block.  Burst ownership: the block
        whose core region contains the sync trigger; a right-margin of one
        max burst window lets owned bursts complete past the core edge, and
        cross-block greedy state (prev_end, resumable via checkpoint)
        prevents re-decoding a burst that re-syncs inside a previous
        block's span.  start_block skips already-decoded blocks exactly:
        segments are addressed by absolute position, so a resumed stream
        yields byte-identical blocks to an uninterrupted run.
        """
        ch = self.channelizer
        p_in, p_out = ch.p_in, ch.p_out
        lmarg_p, rmarg_p, core_p, _ = stream_geometry(
            p_in, p_out, self.cfg.fs, self.cfg.max_symbols, block_seconds)
        lmarg_dec, core_dec = lmarg_p * p_out, core_p * p_out
        t = len(x)
        n_core = -(-t // (core_p * p_in))
        total_dec = (t // p_in) * p_out
        c = len(self.f_offsets)
        if prev_end is None:
            prev_end = {}

        if hasattr(x, "read"):
            read = x.read
        else:
            def read(start: int, n: int) -> np.ndarray:
                s_lo, s_hi = max(start, 0), min(start + n, t)
                if s_lo == start and s_hi == start + n:
                    return x[start : start + n]
                out = np.zeros(n, dtype=x.dtype)
                if s_hi > s_lo:
                    out[s_lo - start : s_hi - start] = x[s_lo:s_hi]
                return out

        for i in range(start_block, n_core):
            lo_p = i * core_p - lmarg_p
            seg = read(lo_p * p_in, (lmarg_p + core_p + rmarg_p) * p_in)
            y = ch(seg, period0=lo_p)
            # core ownership enforced ON DEVICE: margin triggers neither
            # occupy decode slots nor count in the stage counters, and t0
            # comes back core-relative
            cands = self._decode_block(jnp.asarray(y), lmarg_dec, core_dec)
            if self.metrics is not None:
                self.metrics.decimated_samples += c * max(
                    0, min(core_dec, total_dec - i * core_dec)
                )
            yield self._finish(cands, t_offset=i * core_dec,
                               prev_end=prev_end)

    def stream_wideband_u8(self, raw: np.ndarray, block_seconds: float = 2.0,
                           pipelined: bool = True, start_block: int = 0,
                           prev_end: dict[int, int] | None = None,
                           fmt: str = "cu8"):
        """Fast streaming decode of a native-format capture: fixed
        overlapping raw blocks through the fused device program (one
        dispatch + one fetch per block, optionally overlapped via
        PipelinedDecoder).  raw may be a np.memmap in the capture's native
        dtype — segments are sliced by absolute position, so memory stays
        constant and start_block resumes exactly (byte-identical blocks vs
        an uninterrupted run; pass the checkpointed prev_end to also
        restore cross-block burst-span suppression).

        Requires lo_wrap=True (the reference's LO mode, the default): the
        fused program is block-position independent there.
        Yields lists of DecodedBurst.
        """
        assert self.cfg.lo_wrap, "fused streaming requires lo_wrap=True"
        assert self.cfg.filter_mode == "boxcar", (
            "the fused device program is boxcar-only; use stream_wideband "
            "for filter_mode='fir'"
        )
        ch = self.channelizer
        per, pad_val = RAW_FMT[fmt]
        p_in, p_out = ch.p_in, ch.p_out
        lmarg_p, rmarg_p, core_p, total_p = stream_geometry(
            p_in, p_out, self.cfg.fs, self.cfg.max_symbols, block_seconds)
        lmarg_dec = lmarg_p * p_out
        core_dec = core_p * p_out

        t_samp = len(raw) // per
        total_dec = (t_samp // p_in) * p_out
        n_core = -(-t_samp // (core_p * p_in))
        n_chan = len(self.f_offsets)
        pd = (PipelinedDecoder(self, fmt=fmt, core_start=lmarg_dec,
                               core_len=core_dec)
              if pipelined else None)
        if prev_end is None:
            prev_end = {}
        pending: list[int] = []                        # t_off FIFO

        def seg_bytes(i):
            lo = (i * core_p - lmarg_p) * p_in * per
            hi = lo + total_p * p_in * per
            seg = np.full(hi - lo, pad_val,
                          dtype=raw.dtype if hasattr(raw, "dtype")
                          else np.uint8)
            s_lo, s_hi = max(lo, 0), min(hi, per * t_samp)
            if s_hi > s_lo:
                seg[s_lo - lo : s_hi - lo] = raw[s_lo:s_hi]
            return seg

        def finish(cands, t_off):
            # core ownership already enforced on device (t0 core-relative)
            if self.metrics is not None:
                i = t_off // core_dec
                self.metrics.decimated_samples += n_chan * max(
                    0, min(core_dec, total_dec - i * core_dec)
                )
            return self._finish(cands, t_offset=t_off, prev_end=prev_end)

        try:
            for i in range(start_block, n_core):
                t_off = i * core_dec
                if pd is None:
                    yield finish(
                        self.decode_wideband_u8(seg_bytes(i), fmt=fmt,
                                                core_start=lmarg_dec,
                                                core_len=core_dec),
                        t_off,
                    )
                else:
                    pending.append(t_off)
                    for cands in pd.submit(seg_bytes(i)):
                        yield finish(cands, pending.pop(0))
            if pd is not None:
                for cands in pd.drain():
                    yield finish(cands, pending.pop(0))
        finally:
            if pd is not None:
                pd.close()      # even when the generator is abandoned

    def stream_live(self, source, fmt: str = "cu8", block_seconds: float = 2.0):
        """Incremental decode of a pipe/growing stream (e.g. rtl_sdr |).

        Maintains the stream overlap across reads; yields lists of
        DecodedBurst as each core block completes.  Fixed block shapes keep
        one compiled program.  With the reference LO mode (lo_wrap, the
        default) the blocks go through the fused device-ingest program:
        native bytes on the link, convert+channelize+decode in one
        dispatch, overlapped via PipelinedDecoder.
        """
        if self.cfg.lo_wrap and self.cfg.filter_mode == "boxcar":
            yield from self._stream_live_fused(source, fmt, block_seconds)
            return
        from .io.live import stream_blocks

        p_in = self.channelizer.p_in
        raw_per_block = max(p_in, int(block_seconds * self.cfg.fs) // p_in * p_in)
        lmargin = 160
        rmargin = 24 + 8 * self.cfg.max_symbols
        core = raw_per_block // p_in * self.channelizer.p_out
        c = len(self.f_offsets)
        tail = np.zeros((c, 0, 2), dtype=np.float32)
        base = 0                       # global index of tail[:, 0]
        prev_end = {ci: -1 for ci in range(c)}
        for x in stream_blocks(source, fmt, raw_per_block):
            y = np.asarray(self.channelizer(x[: raw_per_block]))
            buf = np.concatenate([tail, y], axis=1)
            # decode the core [base+len(tail)-?]: we decode the region that
            # now has a full right margin: core region start = base_core
            while buf.shape[1] >= lmargin + core + rmargin:
                seg = buf[:, : lmargin + core + rmargin]
                cands = self._decode_block(jnp.asarray(seg), lmargin, core)
                yield self._finish(cands, t_offset=base + lmargin,
                                   prev_end=prev_end)
                buf = buf[:, core:]
                base += core
            tail = buf
        # flush: pad the remaining tail with zeros
        if tail.shape[1] > lmargin:
            pad = lmargin + core + rmargin - tail.shape[1]
            seg = np.pad(tail, ((0, 0), (0, max(pad, 0)), (0, 0)))
            seg = seg[:, : lmargin + core + rmargin]
            cands = self._decode_block(jnp.asarray(seg), lmargin, core)
            yield self._finish(cands, t_offset=base + lmargin,
                               prev_end=prev_end)

    def _stream_live_fused(self, source, fmt: str, block_seconds: float):
        """Live decode through the fused device-ingest program: a rolling
        raw window (native dtype) feeds the same overlapping segments as
        stream_wideband_u8, dispatched via PipelinedDecoder; memory is
        bounded by one segment regardless of stream length."""
        from .io.live import stream_raw_blocks

        ch = self.channelizer
        per, pad_val = RAW_FMT[fmt]
        p_in, p_out = ch.p_in, ch.p_out
        lmarg_p, rmarg_p, core_p, total_p = stream_geometry(
            p_in, p_out, self.cfg.fs, self.cfg.max_symbols, block_seconds)
        lmarg_dec, core_dec = lmarg_p * p_out, core_p * p_out
        items_p = p_in * per                 # raw array items per period
        dtype = np.uint8 if fmt == "cu8" else (
            np.int16 if fmt == "cs16" else np.float32)

        # rolling window: starts with the zero-history left margin
        win = np.full(lmarg_p * items_p, pad_val, dtype=dtype)
        win_base = -lmarg_p * items_p        # absolute item index of win[0]
        next_block = 0
        blocks_fed = 0
        real_items = [0]                     # items actually read from source
        prev_end: dict[int, int] = {}
        pd = PipelinedDecoder(self, fmt=fmt, core_start=lmarg_dec,
                              core_len=core_dec)
        pending: list[int] = []

        def finish(cands, t_off):
            # core ownership already enforced on device (t0 core-relative)
            if self.metrics is not None:
                total_dec = (real_items[0] // items_p) * p_out
                i = t_off // core_dec
                self.metrics.decimated_samples += len(self.f_offsets) * max(
                    0, min(core_dec, total_dec - i * core_dec)
                )
            return self._finish(cands, t_offset=t_off, prev_end=prev_end)

        def ready_segments():
            nonlocal win, win_base, next_block
            while True:
                seg_lo = (next_block * core_p - lmarg_p) * items_p
                seg_hi = seg_lo + total_p * items_p
                if seg_hi > win_base + len(win):
                    return
                yield win[seg_lo - win_base : seg_hi - win_base]
                next_block += 1
                keep_from = (next_block * core_p - lmarg_p) * items_p
                if keep_from > win_base:
                    win = win[keep_from - win_base :]
                    win_base = keep_from

        try:
            for raw in stream_raw_blocks(source, fmt, core_p * p_in,
                                         counter=real_items):
                win = np.concatenate([win, raw])
                blocks_fed += 1
                for seg in ready_segments():
                    pending.append(next_block * core_dec)
                    for cands in pd.submit(seg):
                        yield finish(cands, pending.pop(0))
            # EOF: pad the right margin so every fed block decodes
            if next_block < blocks_fed:
                need = ((blocks_fed * core_p + rmarg_p) * items_p
                        - (win_base + len(win)))
                if need > 0:
                    win = np.concatenate(
                        [win, np.full(need, pad_val, dtype=dtype)])
                for seg in ready_segments():
                    pending.append(next_block * core_dec)
                    for cands in pd.submit(seg):
                        yield finish(cands, pending.pop(0))
            for cands in pd.drain():
                yield finish(cands, pending.pop(0))
        finally:
            pd.close()          # even when the generator is abandoned

    def stream_channels(self, y: np.ndarray, core_len: int | None = None):
        if isinstance(y, np.ndarray) and np.iscomplexobj(y):
            y = pack_complex(y)
        c, t = y.shape[:2]
        lmargin = 160
        rmargin = 24 + 8 * self.cfg.max_symbols
        if core_len is None:
            core_len = max(8400, min(t, 4 * 84000))
        prev_end = {ci: -1 for ci in range(c)}
        for i in range(0, t, core_len):
            seg = np.zeros((c, lmargin + core_len + rmargin, 2), dtype=np.float32)
            lo = i - lmargin
            hi = i + core_len + rmargin
            src_lo, src_hi = max(lo, 0), min(hi, t)
            seg[:, src_lo - lo : src_lo - lo + (src_hi - src_lo)] = y[:, src_lo:src_hi]
            # ownership (trigger inside the core region) enforced on device
            cands = self._decode_block(jnp.asarray(seg), lmargin, core_len)
            if self.metrics is not None:
                self.metrics.decimated_samples += c * min(core_len, t - i)
            yield self._finish(cands, t_offset=i, prev_end=prev_end)

    # -- host finisher -------------------------------------------------------
    def _finish(
        self,
        cands: list[dict],
        t_offset: int,
        prev_end: dict[int, int] | None = None,
    ) -> list[DecodedBurst]:
        """Greedy first-trigger-wins over time-sorted candidates, then HDLC
        deframe (the serial reference suspends sync search during a burst,
        so later triggers inside an accepted span are discarded)."""
        bursts: list[DecodedBurst] = []
        if prev_end is None:
            prev_end = {}
        for cd in sorted(cands, key=lambda d: (d["chan"], d["t0"])):
            ci = cd["chan"]
            t0 = cd["t0"] + t_offset          # global index
            if t0 <= prev_end.get(ci, -1):
                continue
            span = burst_span_samples(cd["consumed"], cd["of"])
            nbrow, nlbyte = cd["nbrow"], cd["nlbyte"]
            block = cd["block"][:nbrow]
            fr_hz = self.cfg.freqs_hz[ci] if ci < len(self.cfg.freqs_hz) else 0.0
            ppm = 10500.0 * cd["df"] / (TWO_PI * fr_hz) * 1e6 if fr_hz else 0.0
            burst = DecodedBurst(
                channel=ci,
                t0=t0,
                time_s=t0 / DEMOD_RATE,
                freq_hz=fr_hz,
                ppm=ppm,
                length_bits=cd["length"],
                nbrow=nbrow,
                nlbyte=nlbyte,
                block=block,
                rs_counts=[int(v) for v in cd["rs_counts"][:nbrow]],
            )
            burst.frames = deframe_corrected(block, nbrow, nlbyte)
            # Span occupancy: a burst that yielded at least one CRC-valid
            # frame occupies its span (first-trigger-wins, replicating the
            # serial decoder's suspended sync search).  A 0-frame decode is
            # overwhelmingly a junk trigger whose chaotic header length
            # (d8psk.c:90-107 accepts any <=8-row value) would otherwise
            # block the channel for thousands of samples and swallow REAL
            # bursts behind it — the reference does exactly that (it stays
            # in GETDATA for the garbage length), which is its known recall
            # weakness (PARITY.md divergence 1); we resume immediately.
            # CRC-failed junk produces no output either way, so the only
            # observable difference is strictly more decoded frames.
            if burst.frames:
                prev_end[ci] = t0 + span
            bursts.append(burst)
        return bursts


class PipelinedDecoder:
    """Overlapped dispatch/fetch for the fused fast path.

    Dispatch is asynchronous: submit() enqueues the block's program and
    returns, and fetch threads behind the dispatcher wait for each result
    and copy it to the host, so the upload and host decode of one block
    overlap the device compute of the next.  workers>1 runs several
    fetches concurrently; results are re-ordered to submission order
    before being yielded.

    Usage:
        pd = PipelinedDecoder(pipe)
        for raw_block in blocks:
            for cands in pd.submit(raw_block):
                ...
        for cands in pd.drain():
            ...
    """

    def __init__(self, pipe: "Pipeline", depth: int | None = None,
                 fmt: str = "cu8", workers: int = 1,
                 core_start: int = 0, core_len: int = 0):
        import queue
        import threading

        self.pipe = pipe
        self.workers = max(1, workers)
        self.depth = depth if depth is not None else self.workers + 1
        self.fmt = fmt
        self.core_start = core_start
        self.core_len = core_len
        self._q = queue.Queue(maxsize=self.depth)
        self._lock = threading.Condition()
        self._results: dict[int, object] = {}
        self._seq_in = 0                   # blocks dispatched
        self._seq_out = 0                  # blocks yielded
        self._stopping = False             # sentinels posted
        self._threads = [
            threading.Thread(target=self._fetch_loop, daemon=True)
            for _ in range(self.workers)
        ]
        for th in self._threads:
            th.start()

    def _fetch_loop(self):
        import time as _time

        while True:
            item = self._q.get()
            if item is None:
                return
            seq, buf = item
            try:
                t_start = _time.perf_counter()
                host_buf = np.asarray(buf)
                self.pipe._observe_packed(
                    host_buf, _time.perf_counter() - t_start
                )
                r = unpack_results(host_buf)
            except Exception as e:          # surface errors to the consumer
                r = e
            with self._lock:
                self._results[seq] = r
                self._lock.notify_all()

    def _emit_ready(self, wait: bool = False):
        while True:
            with self._lock:               # never yield while holding this
                if self._seq_out >= self._seq_in:
                    return
                while self._seq_out not in self._results:
                    if not wait:
                        return
                    self._lock.wait()
                r = self._results.pop(self._seq_out)
                self._seq_out += 1
            if isinstance(r, Exception):
                raise r
            yield r

    def _dispatch(self, raw: np.ndarray):
        return _dispatch_fused(self.pipe, raw, self.fmt,
                               self.core_start, self.core_len)

    def submit(self, raw: np.ndarray):
        """Dispatch a block; yields any already-completed blocks' candidates
        in submission order (non-blocking unless the pipeline is full)."""
        buf = self._dispatch(raw)
        self._q.put((self._seq_in, buf))
        with self._lock:
            self._seq_in += 1
        yield from self._emit_ready(wait=False)

    def _stop(self):
        if not self._stopping:
            self._stopping = True
            for _ in self._threads:
                self._q.put(None)

    def close(self):
        """Stop and JOIN the fetch workers.  Idempotent; callers must
        reach this on every exit path (the streaming generators do it in
        a finally):  a daemon thread still blocked in queue.get() at
        interpreter shutdown gets pthread_exit()ed by CPython, whose
        forced unwind aborts the process when it crosses C++ frames
        ("FATAL: exception not rethrown", SIGABRT) — observed ~1/10 CLI
        runs under load before this join existed."""
        self._stop()
        for th in self._threads:
            th.join(timeout=300)

    def drain(self):
        """Finish: yields remaining results in order; the decoder is then
        closed."""
        self._stop()
        yield from self._emit_ready(wait=True)
        self.close()


def deframe_corrected(block: np.ndarray, nbrow: int, nlbyte: int) -> list[np.ndarray]:
    """HDLC unstuff + flag scan + CRC over an RS-corrected block.

    Uses the native C++ decoder (native/hostdec.cpp) when built; the pure
    Python path is behaviour-identical (differential-tested).
    """
    from .host.native import deframe_block_native

    frames = deframe_block_native(block, nbrow, nlbyte)
    if frames is not None:
        return frames
    un = Unstuffer()
    for r in range(nbrow):
        by = nlbyte if r == nbrow - 1 else RS_K
        for i in range(by):
            un.push_byte(int(block[r, i]))
    return [f for f in un.frames if frame_crc_ok(f)]
