"""Benchmark: wideband IQ decode throughput on one chip.

Measures the full device pipeline (channelizer -> polyphase filter -> sync
scan -> candidate demod -> header -> assembly -> RS) on a realistic 2 Msps
VDL-M2 load.  Host->device transfer of the raw IQ block is included in the
timed loop.  The default run times three configs:

  * 8 channels  (the reference's maximum, which it decodes in real time on
    a CPU at 2.0 Msamples/s) — the headline metric;
  * 64 channels (8x the reference's capability in one program);
  * 76 channels at 25 kHz spacing — the FULL usable 2 MHz span (the
    chooseFc constraint |fc-f| <= fs/2 - 2*STEP caps the span at 1.9 MHz,
    i.e. 76 channels).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
vs_baseline = achieved Msamples/s / 2.0 (the reference's real-time rate).
extra carries the scale configs as channel-realtime equivalents
(channels * msps / 2.0 = how many reference instances one chip replaces).

--analysis adds per-stage device timings and roofline proxies (pure-matmul
and HBM-copy microbenchmarks) — opt-in because each stage is a separate
compile.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def make_capture(fs: int, n_channels: int, seconds: float, seed: int = 0,
                 spacing: int = 50_000, active_every: int = 1,
                 base: int | None = None, impaired: bool = True,
                 gap: tuple[int, int] = (2000, 12000)):
    """Wideband capture with periodic bursts on every active_every-th
    channel (sync/filter cost is per-channel regardless of traffic, so
    sparse activity keeps large-channel-count synthesis affordable).

    impaired=True (the default) gives every burst a random
    carrier-frequency offset (uniform +-400 Hz ~ +-3 ppm of the RF
    channel, the reference's correction range at d8psk.c:302), a random
    level in an 18 dB spread, a random carrier phase and a fractional-
    sample timing phase — so the recall gate actually exercises the
    sync/CFO/timing estimators.  The spread sits
    ABOVE the old clean level: strongest 8x (18 dB), weakest 1x — the
    u8 quantizer is a hard floor (1 LSB ~ the clean amplitude; bursts
    below ~0.3 LSB vanish entirely: measured 0/9 recall at 0.126x), so
    the near-far range is placed on top of it, exactly like a real
    8-bit SDR where strong stations ride well above the ADC floor.
    impaired=False is the old clean-signal stimulus.  gap: the range of
    idle 84 kHz samples between a channel's bursts (the default packs
    ~8 bursts/s per channel).

    Returns (wide, freqs, fc, truth) where truth is the per-burst ground
    truth [(channel_index, frame content bytes, start84, len84), ...]
    used for recall matching (positions at the 84 kHz decimated rate, so
    the matcher can exclude bursts outside a truncated decode span).  Synthesis is pure-host and slow, so the result is cached on
    disk keyed by parameters."""
    import os
    import tempfile

    cache = os.path.join(
        tempfile.gettempdir(),
        f"vdlm2_bench9_{fs}_{n_channels}_{seconds}_{seed}_{spacing}_"
        f"{active_every}_{base}_{int(impaired)}_{gap[0]}_{gap[1]}.npz",
    )
    if os.path.exists(cache):
        try:
            z = np.load(cache)
            lens = z["truth_lens"]
            blob = z["truth_blob"].tobytes()
            offs = np.concatenate(([0], np.cumsum(lens)))
            truth = [(int(c), blob[offs[i]:offs[i + 1]], int(p0), int(pl))
                     for i, (c, p0, pl) in enumerate(zip(
                         z["truth_chan"], z["truth_pos"], z["truth_len84"]))]
            return (z["wide"], [int(f) for f in z["freqs"]], int(z["fc"]),
                    truth)
        except Exception:
            pass

    from vdlm2dec_tpu import modulator as mod
    from vdlm2dec_tpu.constants import DEMOD_RATE

    rng = np.random.default_rng(seed)
    if base is None:
        base = 136_600_000 if n_channels <= 32 else 136_050_000
    freqs = [base + spacing * i for i in range(n_channels)]
    # fc on the 25 kHz raster (like chooseFc in practice): offsets stay
    # raster multiples, so the wrapped-LO modes (incl. the residue-space
    # channelizer) see a phase-continuous LO
    fc = round(((min(freqs) + max(freqs)) // 2 - 287_500) / 25_000) * 25_000
    if max(abs(fc - f) for f in freqs) > fs // 2 - 50_000:
        fc = round((min(freqs) + max(freqs)) / 2 / 25_000) * 25_000
    # every channel must fit inside Nyquist: an offset beyond fs/2 aliases
    # back by exactly fs, landing ON another channel of the raster and
    # duplicating its bursts at full strength (the round-2 64ch config's
    # 3.2 MHz span in a 2 Msps capture did exactly this: 143 frames from
    # 98 bursts — see PERF.md "64ch anomaly")
    worst = max(abs(fc - f) for f in freqs)
    if worst > fs // 2 - 12_500:
        raise ValueError(
            f"channel plan spans {worst} Hz from fc but Nyquist is "
            f"{fs // 2} Hz: channels would alias onto each other"
        )
    total_wide = int(fs * seconds)
    total_bb = int(DEMOD_RATE * seconds)
    wide = np.zeros(total_wide, dtype=np.complex128)
    truth: list[tuple[int, bytes, int, int]] = []
    for ci, f in enumerate(freqs):
        if ci % active_every:
            continue
        bb = np.zeros(total_bb, dtype=np.complex128)
        # stagger start positions per channel, WRAPPED into the first half
        # of the capture so every active channel gets at least one burst
        # even at thousands of channels (unwrapped, 977*ci outran short
        # captures past ci~80 and the 2000-channel recall gate degenerated
        # to 2 bursts on channel 0)
        pos = 500 + (977 * ci) % max(1, total_bb // 2)
        while pos + 3000 < total_bb:
            content = rng.integers(0, 256, int(rng.integers(20, 120))).astype(np.uint8)
            if content[0] == 0x7E:
                # a frame whose FIRST content byte is 0x7E is undecodable
                # by the reference's unstuffer (vdlm2.c flag scan: at k==1
                # an unstuffed 0x7E is indistinguishable from a repeated
                # flag and is eaten, so the CRC can never pass) — and ours
                # replicates that semantics exactly.  Interior/trailing/
                # FCS 0x7E bytes roundtrip fine (verified in
                # test_golden_codec.py); only the lead byte must be
                # excluded from synthesized truth.  Real AVLC first bytes
                # are address octets, so this matches transmitter reality.
                content[0] = 0x7D
            plan = mod.make_burst([content])
            if impaired:
                burst = mod.synthesize_baseband(
                    plan, start=0, total=None,
                    cfo_hz=float(rng.uniform(-400.0, 400.0)),
                    phase0=float(rng.uniform(0.0, 2 * np.pi)),
                    timing_frac=float(rng.uniform(0.0, 1.0)),
                    amplitude=float(
                        8.0 * 10 ** (rng.uniform(-18.0, 0.0) / 20)),
                )
            else:
                burst = mod.synthesize_baseband(plan, start=0, total=None)
            if pos + len(burst) > total_bb:
                # a clipped burst is unrecoverable by construction — it
                # must not enter the capture OR the truth list (one such
                # edge burst was the 64ch config's lone recall miss)
                break
            bb[pos : pos + len(burst)] += burst
            truth.append((ci, content.tobytes(), pos, len(burst)))
            pos += len(burst) + int(rng.integers(*gap))
        wide += mod.upsample_to_wideband(bb, fs, f - fc, total=total_wide)
    noise = rng.normal(size=total_wide) + 1j * rng.normal(size=total_wide)
    wide = (wide + 0.02 * noise).astype(np.complex64)
    try:
        np.savez(cache, wide=wide, freqs=np.array(freqs), fc=fc,
                 truth_chan=np.array([t_[0] for t_ in truth], np.int32),
                 truth_lens=np.array([len(t_[1]) for t_ in truth],
                                     np.int64),
                 truth_blob=np.frombuffer(
                     b"".join(t_[1] for t_ in truth), np.uint8),
                 truth_pos=np.array([t_[2] for t_ in truth], np.int64),
                 truth_len84=np.array([t_[3] for t_ in truth], np.int64))
    except OSError:
        pass
    return wide, freqs, fc, truth


def to_u8(wide: np.ndarray) -> np.ndarray:
    from vdlm2dec_tpu.io.sdr import RTL_DC_OFFSET

    inter = np.empty(2 * len(wide), dtype=np.float32)
    inter[0::2] = wide.real + RTL_DC_OFFSET
    inter[1::2] = wide.imag + RTL_DC_OFFSET
    return np.clip(np.round(inter), 0, 255).astype(np.uint8)


def run_config(channels: int, seconds: float, iters: int, max_symbols: int,
               max_candidates: int | None,
               spacing: int = 50_000, active_every: int = 1,
               profile_dir: str | None = None,
               fetch_workers: int = 1, fs: int = 2_000_000,
               base: int | None = None, chan_impl: str = "matmul",
               block_seconds: float | None = None,
               compute: str = "f32", sync_impl: str = "xla") -> dict:
    """Time the pipelined u8 fast path on one config; returns stats."""
    import jax

    from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig, PipelinedDecoder

    wide, freqs, fc, truth = make_capture(
        fs, channels, seconds, spacing=spacing, active_every=active_every,
        base=base)
    n_bursts = len(truth)
    max_cand = max_candidates or max(16, int(16 * seconds))
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs],
        fs=fs,
        fc_hz=float(fc),
        lo_wrap=(chan_impl in ("dft", "pfb", "auto")),  # residue impls need the wrapped LO
        max_candidates=max_cand,
        max_symbols=max_symbols,
        chan_impl=chan_impl,
        compute=compute,
        sync_impl=sync_impl,
        # decode slots sized for dense traffic (~11 bursts/s/channel at
        # median burst length) x2 headroom for re-trigger/garbage
        # candidates, which occupy slots too (the round-3 recall gate
        # caught 2/98 bursts dropped at the tighter estimate)
        max_out=max(64, int(22 * seconds * channels // max(active_every, 1))),
    )
    pipe = Pipeline(cfg)
    t = len(wide) - len(wide) % pipe.channelizer.p_in
    raw_u8 = to_u8(wide[:t])

    # correctness sanity + warm-up compile of the exact timed program
    if block_seconds:
        bursts = [b for bs_ in pipe.stream_wideband_u8(
            raw_u8, block_seconds=block_seconds) for b in bs_]
        n_cands = len(bursts)
    else:
        cands = pipe.decode_wideband_u8(raw_u8)
        bursts = pipe._finish(cands, 0)
        n_cands = len(cands)
    n_frames = sum(len(b.frames) for b in bursts)
    # per-burst recall: every synthesized burst must come back on its OWN
    # channel with its exact content; anything else is a duplicate (same
    # (channel, content) twice — e.g. cross-block re-decode), leakage
    # (right content, wrong channel — e.g. adjacent-channel or alias
    # images) or spurious (content matching nothing synthesized)
    from collections import Counter

    # only bursts fully inside the decoded span (t truncated to whole
    # channelizer periods) count toward recall; a truncated-tail burst can
    # STILL decode when RS corrects the missing samples — those count as
    # "edge", not spurious
    span84 = t // pipe.channelizer.p_in * pipe.channelizer.p_out
    in_span = [(c, cb) for c, cb, p0, pl in truth if p0 + pl <= span84]
    out_span_keys = {(c, cb) for c, cb, p0, pl in truth if p0 + pl > span84}
    n_bursts = len(in_span)
    want = Counter(in_span)
    got = Counter()
    for b in bursts:
        for f in b.frames:
            got[(b.channel, bytes(bytearray(f[1:-3])))] += 1
    matched = sum(min(got[k], n) for k, n in want.items())
    missed = n_bursts - matched
    duplicates = sum(max(got[k] - want[k], 0) for k in got if k in want)
    contents = {c for _ch, c in want}
    edge = sum(n for k, n in got.items()
               if k not in want and k in out_span_keys)
    leakage = sum(n for k, n in got.items()
                  if k not in want and k not in out_span_keys
                  and k[1] in contents)
    spurious = sum(n for k, n in got.items()
                   if k not in want and k not in out_span_keys
                   and k[1] not in contents)
    print(
        f"# [{channels}ch] recall {matched}/{n_bursts} "
        f"(missed {missed}, duplicates {duplicates}, leakage {leakage}, "
        f"spurious {spurious}, edge {edge}; {n_frames} frames, "
        f"{n_cands} candidates)",
        file=sys.stderr,
    )
    if missed:
        raise RuntimeError(
            f"{channels}ch recall failure: {missed}/{n_bursts} synthesized "
            f"bursts not recovered on their own channel")

    profile_cm = jax.profiler.trace(profile_dir) if profile_dir else None
    if profile_cm:
        profile_cm.__enter__()
    if block_seconds:
        # compile-bounded scale configs: stream fixed core blocks through
        # the pipelined fused program (the production streaming shape)
        t0 = time.perf_counter()
        for _ in range(iters):
            for _bursts in pipe.stream_wideband_u8(
                    raw_u8, block_seconds=block_seconds):
                pass
        dt = time.perf_counter() - t0
    else:
        # pipelined loop: fetch threads behind the dispatcher overlap
        # transfers with device compute (production streaming shape);
        # two passes, keep the better
        dts = []
        for _pass in range(2):
            pd = PipelinedDecoder(pipe, workers=fetch_workers)
            n_res = 0
            t0 = time.perf_counter()
            for _ in range(iters):
                for _cands in pd.submit(raw_u8):
                    n_res += 1
            for _cands in pd.drain():
                n_res += 1
            dts.append(time.perf_counter() - t0)
            assert n_res == iters
        dt = min(dts)
    if profile_cm:
        profile_cm.__exit__(None, None, None)

    msps = t * iters / dt / 1e6
    # one chip replaces this many real-time reference instances at this
    # channel count: channels x (achieved rate / the capture's own rate)
    chan_rt = channels * msps / (fs / 1e6)
    print(
        f"# [{channels}ch] {dt:.3f}s for {iters} x {t} samples: "
        f"{msps:.1f} Msps = {chan_rt:.0f} channel-realtime equivalents",
        file=sys.stderr,
    )
    return {"channels": channels, "msps": round(msps, 2),
            "channel_realtime_equivalents": round(chan_rt, 0),
            "frames": n_frames, "bursts": n_bursts,
            "recall": f"{matched}/{n_bursts}", "duplicates": duplicates,
            "leakage": leakage, "spurious": spurious, "edge": edge}


def run_device_config(channels: int, seconds: float, outer: int, inner: int,
                      max_symbols: int, max_candidates: int | None,
                      spacing: int = 50_000,
                      active_every: int = 1, fs: int = 2_000_000,
                      base: int | None = None, chan_impl: str = "matmul",
                      compute: str = "f32", sync_impl: str = "xla",
                      mfu: bool = True,
                      probe_seconds: float | None = None) -> dict:
    """Chip-bound throughput: raw IQ staged on device ONCE, `inner` full
    decodes chained per dispatch (pipeline.make_device_probe), only a
    4-byte checksum fetched — upload, fetch and host decode are out of
    the timed loop, unlike run_config's fetch-to-fetch Msps.

    mfu=True adds device-resident roofline proxies (same salt-loop trick):
    f32 matmul peak, HBM read bandwidth, and a channelize-only timing ->
    channelizer MFU vs matmul peak.  The hot loop being replaced is the
    reference's per-sample mixer/decimator (d8psk.c:366-381)."""
    import jax
    import jax.numpy as jnp

    from vdlm2dec_tpu.pipeline import (
        Pipeline,
        PipelineConfig,
        make_device_probe,
    )

    wide, freqs, fc, truth = make_capture(
        fs, channels, seconds, spacing=spacing, active_every=active_every,
        base=base)
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=fs, fc_hz=float(fc),
        lo_wrap=(chan_impl in ("dft", "pfb", "auto")),
        max_candidates=max_candidates or max(16, int(16 * seconds)),
        max_symbols=max_symbols,
        chan_impl=chan_impl, compute=compute, sync_impl=sync_impl,
        max_out=max(64, int(22 * seconds * channels
                            // max(active_every, 1))),
    )
    pipe = Pipeline(cfg)
    if probe_seconds is not None:
        wide = wide[: int(probe_seconds * fs)]
    raw_u8 = to_u8(wide)
    probe, raw_dev, t = make_device_probe(pipe, raw_u8)
    salts = jnp.arange(1, inner + 1, dtype=jnp.uint8)
    r = probe(raw_dev, salts)                    # compile + warm
    jax.block_until_ready(r)
    chk = int(np.asarray(r))
    # each outer pass timed separately: the in-artifact spread is what
    # lets a reader tell a regression from run-to-run noise
    msps_passes = []
    for i in range(outer):
        t0 = time.perf_counter()
        jax.block_until_ready(probe(raw_dev, salts + jnp.uint8(i)))
        msps_passes.append(t * inner / (time.perf_counter() - t0) / 1e6)
    n = outer * inner
    msps_passes.sort()
    dev_msps = msps_passes[len(msps_passes) // 2]     # median
    chan_rt = channels * dev_msps / (fs / 1e6)
    out = {"channels": channels, "device_msps": round(dev_msps, 2),
           "device_msps_passes": [round(m, 2) for m in msps_passes],
           "channel_realtime_equivalents": round(chan_rt, 0),
           "blocks_timed": n, "block_samples": t, "checksum": chk,
           "fetch_amortisation": inner}
    print(f"# [device {channels}ch] {n} x {t} samples: "
          f"{dev_msps:.1f} Msps chip-bound (median; passes "
          f"{[round(m, 1) for m in msps_passes]}) = {chan_rt:.0f} "
          f"channel-realtime equivalents", file=sys.stderr)

    if mfu:
        try:
            out.update(_mfu_probes(pipe, wide, t, freqs, fs))
        except Exception as e:       # never lose the msps to a probe fail
            print(f"# mfu probes failed: {e}", file=sys.stderr)
            out["mfu_error"] = str(e)
    return out


def _mfu_probes(pipe, wide, t, freqs, fs) -> dict:
    """Device-resident roofline proxies + channelize-only MFU (salt-loop,
    scalar fetch).  Split out of run_device_config so a probe failure
    can't cost the chip-bound msps, and so BOTH device legs (8ch and the
    whole-band pfb config) carry {matmul_peak, hbm, mfu}."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    out: dict = {}
    channels = len(freqs)
    # f32 matmul peak, device-resident (salt loop, one scalar fetch)
    k = 4096
    a = jax.device_put(jnp.ones((k, k), jnp.float32))
    mm_inner = 8

    @jax.jit
    def mm(a, s):
        def body(i, acc):
            return acc + ((a + s[i]) @ a)[0, 0]

        return lax.fori_loop(0, s.shape[0], body, jnp.float32(0))

    s = jnp.arange(mm_inner, dtype=jnp.float32) * 1e-7
    _ = np.asarray(mm(a, s))
    t0 = time.perf_counter()
    for _i in range(3):
        _ = np.asarray(mm(a, s))
    mm_dt = (time.perf_counter() - t0) / 3
    matmul_flops = 2 * k**3 * mm_inner / mm_dt

    # HBM read bandwidth, device-resident
    big = jax.device_put(jnp.ones((256, 1 << 20), jnp.float32))  # 1 GiB

    @jax.jit
    def rd(b, s):
        def body(i, acc):
            return acc + (b * (1 + s[i])).sum()

        return lax.fori_loop(0, s.shape[0], body, jnp.float32(0))

    _ = np.asarray(rd(big, s))
    t0 = time.perf_counter()
    for _i in range(3):
        _ = np.asarray(rd(big, s))
    rd_dt = (time.perf_counter() - t0) / 3
    hbm_read = big.size * 4 * mm_inner / rd_dt

    # channelize-only, device-resident (the stage with the FLOPs)
    x_dev = jax.device_put(jnp.asarray(np.stack(
        [wide[:t].real, wide[:t].imag], -1).astype(np.float32)))

    @jax.jit
    def chan(v, s):
        def body(i, acc):
            return acc + pipe.channelizer(
                v.at[0, 0].add(s[i])).sum()

        return lax.fori_loop(0, s.shape[0], body, jnp.float32(0))

    _ = np.asarray(chan(x_dev, s))
    t0 = time.perf_counter()
    for _i in range(3):
        _ = np.asarray(chan(x_dev, s))
    ch_dt = (time.perf_counter() - t0) / 3 / mm_inner
    c = len(freqs)
    ch = pipe.channelizer
    p_in, p_out = ch.p_in, ch.p_out
    nb = t // p_in
    # ACTUAL flops of the impl in use (the dft/pfb impls do the same
    # products in far fewer MACs — MFU must measure how well the device
    # runs what was actually dispatched, not the dense formulation)
    from vdlm2dec_tpu.constants import STEPRATE

    # qr residue contraction (both residue impls):
    # 2 planes x 2*Q*tbl*84 MACs per period = 4*p_in*84 flops/period
    z_f = 4 * p_in * p_out * nb
    if ch.impl == "dft":
        tbl = fs // STEPRATE
        achieved_f = z_f + 8 * c * tbl * nb * p_out
    elif ch.impl == "pfb":
        fa, fb = ch._pfb_a, ch._pfb_b
        achieved_f = z_f + (8 * fa * (fa + fb) * fb
                            + 6 * fa * fb) * nb * p_out
    else:
        # mix 12 flops/(chan,sample) + aggregate matmul 4*P_out each
        achieved_f = c * t * (12 + 4 * p_out)
    achieved = achieved_f / ch_dt
    # dense-equivalent rate: the work the reference's dense mix+dump
    # formulation would need for the same output, per second — the
    # honest cross-impl comparator now that the dft/pfb impls optimize
    # FLOPs away rather than raising matmul occupancy.  Raw MFU-vs-peak
    # is reported but near-zero by construction for the cheap impls.
    dense_equiv = c * t * (12 + 4 * p_out) / ch_dt
    out.update({
        "matmul_peak_gflops_f32": round(matmul_flops / 1e9, 1),
        "hbm_read_gbps": round(hbm_read / 1e9, 1),
        "channelize_ms": round(ch_dt * 1e3, 2),
        "channelizer_impl": ch.impl,
        "channelizer_gflops": round(achieved / 1e9, 1),
        "channelizer_dense_equiv_gflops": round(dense_equiv / 1e9, 1),
        "channelizer_mfu_vs_matmul_peak": round(
            achieved / matmul_flops, 4),
    })
    print(f"# [device {channels}ch] matmul peak "
          f"{out['matmul_peak_gflops_f32']} Gflop/s, HBM read "
          f"{out['hbm_read_gbps']} GB/s, channelize "
          f"{out['channelize_ms']} ms = {out['channelizer_gflops']} "
          f"Gflop/s (MFU {out['channelizer_mfu_vs_matmul_peak']})",
          file=sys.stderr)
    return out


def run_analysis(seconds: float, iters: int, max_symbols: int,
                 compute: str = "f32",
                 sync_impl: str = "xla") -> dict:
    """Per-stage device timing + roofline proxies.  Each stage is jitted
    separately (own compile); timings are fetch-to-fetch, so they include
    the transfer of each stage's (small) probe output."""
    import jax
    import jax.numpy as jnp

    from vdlm2dec_tpu.ops.demod import (
        find_triggers,
        phase_of,
        polyphase_filter,
        sync_scan,
    )
    from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig

    fs = 2_000_000
    wide, freqs, fc, _ = make_capture(fs, 8, seconds)
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=fs, fc_hz=float(fc),
        lo_wrap=False, max_candidates=16, max_symbols=max_symbols,
        max_out=128, compute=compute,
        sync_impl=sync_impl,
    )
    pipe = Pipeline(cfg)
    t = len(wide) - len(wide) % pipe.channelizer.p_in
    y = np.asarray(pipe.channelizer(wide[:t]))       # (C, T84, 2)
    yj = jnp.asarray(y)
    raw_u8 = to_u8(wide[:t])

    def timed(name, fn, *args, n=max(2, iters // 2)):
        r = fn(*args)                                # compile + warm
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        for _i in range(n):
            _ = np.asarray(fn(*args))
        dt = (time.perf_counter() - t0) / n
        print(f"# stage {name:24s} {dt * 1e3:9.2f} ms", file=sys.stderr)
        return dt

    stages = {}
    # stage probes return small reductions so fetch cost is the link floor
    chan_fn = jax.jit(lambda x: pipe.channelizer(x)[:, ::997].sum())
    stages["channelize"] = timed("channelize", chan_fn,
                                 jnp.asarray(np.stack([wide[:t].real,
                                                       wide[:t].imag], -1)))
    filt_fn = jax.jit(
        lambda v: polyphase_filter(v, compute=compute)[:, 0, ::997].sum())
    stages["polyphase_filter"] = timed("polyphase_filter", filt_fn, yj)

    def sync_fn(v):
        f = polyphase_filter(v, compute=compute)
        err, fr = sync_scan(phase_of(f[:, 0]))
        t0_, of, df, valid, q = find_triggers(err, fr, 16)
        return t0_.sum() + valid.sum()

    stages["filter+sync_scan"] = timed("filter+sync_scan", jax.jit(sync_fn), yj)

    from vdlm2dec_tpu.pipeline import _device_decode_packed_jit

    def full_fn(v):
        return _device_decode_packed_jit(v, 16, max_symbols, 128,
                                         compute=compute,
                                         sync_impl=sync_impl)

    stages["full_decode_packed"] = timed("full_decode_packed", full_fn, yj)
    u8_fn = lambda r: pipe.decode_wideband_u8(r)     # noqa: E731
    r0 = pipe.decode_wideband_u8(raw_u8)             # warm
    t0 = time.perf_counter()
    for _i in range(max(2, iters // 2)):
        pipe.decode_wideband_u8(raw_u8)
    stages["fused_u8_end_to_end"] = (
        (time.perf_counter() - t0) / max(2, iters // 2))
    print(f"# stage {'fused_u8_end_to_end':24s} "
          f"{stages['fused_u8_end_to_end'] * 1e3:9.2f} ms", file=sys.stderr)

    # burst stages = full - (filter + sync); channelizer separate
    burst_s = stages["full_decode_packed"] - stages["filter+sync_scan"]
    print(f"# stage {'burst stages (derived)':24s} {burst_s * 1e3:9.2f} ms",
          file=sys.stderr)

    # roofline proxies on the same device
    k = 4096
    a = jnp.ones((k, k), jnp.float32)
    mm = jax.jit(lambda a: (a @ a)[::1024, ::1024].sum())
    r = mm(a); jax.block_until_ready(r); _ = np.asarray(r)
    t0 = time.perf_counter()
    for _i in range(4):
        _ = np.asarray(mm(a))
    mm_dt = (time.perf_counter() - t0) / 4
    matmul_flops = 2 * k**3 / mm_dt
    big = jnp.ones((256, 1 << 20), jnp.float32)      # 1 GiB
    cp = jax.jit(lambda b: (b * 1.0000001).sum())
    r = cp(big); jax.block_until_ready(r); _ = np.asarray(r)
    t0 = time.perf_counter()
    for _i in range(4):
        _ = np.asarray(cp(big))
    cp_dt = (time.perf_counter() - t0) / 4
    hbm_bw = 2 * big.size * 4 / cp_dt                # read + write

    # channelizer arithmetic per wideband sample (C channels):
    #   mix 12 flops/chan + aggregate matmul 4*P_out flops per period/P_in
    c = len(freqs)
    p_out = pipe.channelizer.p_out
    # mix: two complex mults = 12 flops per (chan, sample); aggregate
    # matmul: 4*P_in*P_out flops per period = 4*P_out per (chan, sample)
    chan_flops_per_s = c * fs * (12 + 4 * p_out)
    achieved = chan_flops_per_s * (t / fs) / stages["channelize"]
    ana = {
        "stage_ms": {kk: round(v * 1e3, 2) for kk, v in stages.items()},
        "burst_stages_ms": round(burst_s * 1e3, 2),
        "matmul_peak_gflops": round(matmul_flops / 1e9, 1),
        "hbm_copy_gbps": round(hbm_bw / 1e9, 1),
        "channelizer_gflops": round(achieved / 1e9, 1),
        "channelizer_mfu_vs_matmul_peak": round(achieved / matmul_flops, 4),
    }
    print(f"# analysis {json.dumps(ana)}", file=sys.stderr)
    return ana


def run_latency(block_seconds: float, seconds: float = 8.0,
                channels: int = 8, max_symbols: int = 512) -> dict:
    """Serving latency: steady-state per-block turnaround (dispatch of a
    raw block -> its candidates on the host) through the production
    pipelined streaming path.  End-to-end burst latency on a live SDR
    feed is bounded by one block period (buffering) + this turnaround.

    Blocks are submitted PACED at real time (block i at t_start +
    i*block_seconds, like a live SDR feed) and the artifact carries
    backlog evidence: turnaround p50 > block period alone does not say
    whether serving keeps up — only pipelining makes it sustainable, so
    we record completion lag vs the real-time schedule over the whole
    run and a sustained verdict (lag flat = keeping up, lag growing =
    falling behind)."""
    import jax  # noqa: F401  (device init before timing)

    from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig

    wide, freqs, fc, _truth = make_capture(2_000_000, channels, seconds,
                                           spacing=25_000, active_every=5)
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=2_000_000, fc_hz=float(fc),
        max_symbols=max_symbols, max_candidates=8,
    )
    pipe = Pipeline(cfg)
    core = pipe.core_raw_samples(block_seconds)
    raw = to_u8(wide)
    n_blocks = len(wide) // core
    from vdlm2dec_tpu.pipeline import PipelinedDecoder, _dispatch_fused

    # warm the compile BEFORE timing: otherwise blocks 1-3 are submitted
    # while block 0 compiles and their turnaround reports the compile,
    # not steady state
    np.asarray(_dispatch_fused(pipe, raw[: 2 * core], "cu8", 0, 0))

    pd = PipelinedDecoder(pipe)
    lat: list[float] = []
    done_lag: list[float] = []           # completion time - block's feed time
    t_sub: dict[int, float] = {}
    max_backlog = 0
    t_start = time.perf_counter()
    rebased = False
    try:
        seen = 0
        for i in range(n_blocks):
            feed_t = t_start + i * block_seconds
            now = time.perf_counter()
            if now < feed_t:             # a live feed delivers on schedule
                time.sleep(feed_t - now)
            t_sub[i] = time.perf_counter()
            max_backlog = max(max_backlog, i + 1 - seen)
            for _res in pd.submit(raw[2 * i * core: 2 * (i + 1) * core]):
                now = time.perf_counter()
                lat.append(now - t_sub[seen])
                done_lag.append(now - (t_start + seen * block_seconds))
                seen += 1
                if not rebased:
                    # rebase the feed schedule on the FIRST completion:
                    # any residual warm-up (compile tail, first dispatch)
                    # would otherwise leave the absolute schedule
                    # permanently in the past and no sleep would ever
                    # fire — "paced" in name only
                    t_start = now - (i + 1) * block_seconds
                    rebased = True
        for _res in pd.drain():
            now = time.perf_counter()
            lat.append(now - t_sub[seen])
            done_lag.append(now - (t_start + seen * block_seconds))
            seen += 1
    finally:
        pd.close()
    lat = lat[1:]                        # drop the compile block
    done_lag = done_lag[1:]
    if not lat:
        return {"error": "capture too short for latency mode"}
    # sustained = completion lag does not grow over the run: compare the
    # median lag of the last quarter against the first quarter.  A
    # pipeline that keeps up has flat lag (~= steady turnaround); one
    # that falls behind accrues ~(turnaround - period) per block.
    q = max(1, len(done_lag) // 4)
    lag_head = sorted(done_lag[:q])[q // 2]
    lag_tail = sorted(done_lag[-q:])[len(done_lag[-q:]) // 2]
    lag_growth = lag_tail - lag_head
    sustained = lag_growth < 0.5 * block_seconds
    lat = sorted(lat)
    pct = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]  # noqa: E731
    out = {"block_seconds": block_seconds, "blocks": len(lat),
           "p50_ms": round(pct(0.50) * 1e3, 1),
           "p95_ms": round(pct(0.95) * 1e3, 1),
           "max_ms": round(lat[-1] * 1e3, 1),
           "paced_realtime": True,
           "max_backlog_blocks": max_backlog,
           "lag_first_quarter_ms": round(lag_head * 1e3, 1),
           "lag_last_quarter_ms": round(lag_tail * 1e3, 1),
           "sustained": bool(sustained)}
    print(f"# latency @{block_seconds}s blocks: p50 {out['p50_ms']} ms, "
          f"p95 {out['p95_ms']} ms, max {out['max_ms']} ms "
          f"({len(lat)} blocks, paced; backlog<={max_backlog}, lag "
          f"{out['lag_first_quarter_ms']}->{out['lag_last_quarter_ms']} ms, "
          f"sustained={sustained})", file=sys.stderr)
    return out


def measure_link_floor(n: int = 24) -> dict:
    """Per-fetch floor: round trip of a minimal dispatch + device->host
    fetch.  Serving latency can never beat this floor plus the block
    period; reporting it alongside p50 makes the latency numbers
    interpretable."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x * 2 + 1)
    x = jnp.ones((8,), jnp.float32)
    _ = np.asarray(f(x))                 # compile + warm
    samples = []
    for _i in range(n):
        t0 = time.perf_counter()
        _ = np.asarray(f(x))
        samples.append(time.perf_counter() - t0)
    samples.sort()
    out = {"p50_ms": round(samples[len(samples) // 2] * 1e3, 1),
           "min_ms": round(samples[0] * 1e3, 1),
           "p95_ms": round(samples[int(0.95 * (len(samples) - 1))] * 1e3, 1)}
    print(f"# link floor: p50 {out['p50_ms']} ms, min {out['min_ms']} ms "
          f"(tiny fetch round-trip, n={n})", file=sys.stderr)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small shapes (CI)")
    # 4 s blocks: the CLI's default block length
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--max-symbols", type=int, default=2048)
    ap.add_argument("--max-candidates", type=int, default=None,
                    help="sync candidates per channel (default: 16/s)")
    ap.add_argument("--fetch-workers", type=int, default=1,
                    help="concurrent result-fetch threads")
    ap.add_argument("--chan-impl", default="auto",
                    choices=["auto", "matmul", "dft", "pfb"],
                    help="auto (the product default) = residue-space dft on"
                         " eligible plans; dft/matmul/pfb force one impl")
    ap.add_argument("--compute", default="f32", choices=["f32", "bf16"],
                    help="bf16 channelizer matmuls (f32 accumulation)")
    ap.add_argument("--sync-impl", default="stream",
                    choices=["xla", "stream"])
    ap.add_argument("--no-scale-configs", dest="scale", action="store_false",
                    help="skip the 64/76-channel configs")
    ap.set_defaults(scale=True)
    ap.add_argument("--band-core", type=float, default=0.5,
                    help="whole-band streaming core seconds per dispatch")
    # default=None sentinel: --quick disables the band leg only when the
    # user did not explicitly ask for it (an explicit --band survives
    # --quick)
    ap.add_argument("--band", action="store_true", default=None,
                    help="add the whole-VDL-band config: 760 channels at "
                         "25 kHz across 118.5-137.5 MHz from a 20 Msps "
                         "capture in ONE device program (default on; "
                         "skipped past --band-budget-s)")
    ap.add_argument("--no-band", dest="band", action="store_false",
                    help="skip the whole-band config")
    ap.add_argument("--no-device", dest="device", action="store_false",
                    help="skip the chip-bound device-resident legs "
                         "(staged input, checksum-only fetch, MFU/roofline)")
    ap.set_defaults(device=True)
    ap.add_argument("--band-budget-s", type=float, default=1100.0,
                    help="start the whole-band config only if wall time is "
                         "below this (the reserve keeps the total run "
                         "bounded)")
    ap.add_argument("--kchan", action="store_true", default=None,
                    help="add the thousands-of-channels config: 2000 "
                         "channels from a synthetic 100 Msps capture in "
                         "ONE device program (BASELINE's 8->thousands "
                         "sweep endpoint; default on, skipped past "
                         "--kchan-budget-s; ~7 min compile)")
    ap.add_argument("--no-kchan", dest="kchan", action="store_false",
                    help="skip the 2000-channel config")
    ap.add_argument("--kchan-budget-s", type=float, default=1300.0,
                    help="start the 2000-channel config only if wall time "
                         "is below this")
    # one tri-state dest: None = default point(s), "all" = every block
    # size, "off" = skip (so --latency --no-latency can't race two dests)
    ap.add_argument("--latency", dest="latency", action="store_const",
                    const="all", default=None,
                    help="measure steady-state per-block turnaround "
                         "(p50/p95) at ALL of 0.1/0.25/0.5/1 s streaming "
                         "blocks; by default the 0.1 s and 0.25 s serving "
                         "points run (~150 s incl. compile)")
    ap.add_argument("--no-latency", dest="latency", action="store_const",
                    const="off",
                    help="skip the default latency points")
    ap.add_argument("--analysis", action="store_true",
                    help="per-stage device timings + roofline proxies "
                         "(several extra compiles)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace of the timed loop")
    ap.add_argument("--budget-s", type=float, default=1500.0,
                    help="skip remaining configs when past this wall time")
    args = ap.parse_args()

    from vdlm2dec_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.quick:
        # 512 symbols covers the largest synthesized burst (120-byte
        # content -> ~460 symbols); 256 truncated the long tail and
        # silently lost ~1/6 of bursts before recall was asserted
        args.seconds, args.iters, args.max_symbols = 0.25, 2, 512
        args.scale = False
        if args.band is None:           # an explicit --band survives --quick
            args.band = False
        if args.latency is None:
            args.latency = "off"

    t_start = time.perf_counter()
    primary = run_config(
        args.channels, args.seconds, args.iters, args.max_symbols,
        args.max_candidates, profile_dir=args.profile,
        fetch_workers=args.fetch_workers, chan_impl=args.chan_impl,
        compute=args.compute, sync_impl=args.sync_impl,
    )
    extra: dict = {}
    if args.device and time.perf_counter() - t_start < args.budget_s:
        # chip-bound counterpart of the primary: same config, upload,
        # fetch and host decode out of the loop
        try:
            extra["device_8ch"] = run_device_config(
                args.channels, args.seconds, 3, 4, args.max_symbols,
                args.max_candidates, chan_impl=args.chan_impl,
                compute=args.compute, sync_impl=args.sync_impl,
            )
        except Exception as e:
            print(f"# device leg failed: {e}", file=sys.stderr)
            extra["device_8ch"] = {"error": str(e)}
    elif args.device:
        extra["device_8ch"] = {"skipped": "past budget"}
    band_cutoff = min(args.budget_s, args.band_budget_s)
    band = args.band if args.band is not None else True
    if band and time.perf_counter() - t_start > band_cutoff:
        print(f"# past band budget ({band_cutoff:.0f}s), skipping "
              "whole-band config", file=sys.stderr)
        # mark the skip in the artifact so a missing band entry is
        # distinguishable from an explicit --no-band
        extra["scale_band_760ch"] = {
            "skipped": f"past band budget ({band_cutoff:.0f}s)"}
    elif band:
        try:
            # the residue-space channelizer is the only formulation that
            # scales here: the dense mix would materialize a (760, B,
            # 20000) intermediate (~60 GB/s of capture); 512 symbols
            # covers the capture's largest bursts.  The stream sync path
            # never builds the (760, 4, T, 2) filter tensor, and the pfb
            # channelizer does O(a+b) work per output against dft's O(C)
            extra["scale_band_760ch"] = run_config(
                760, 1.0, 2, 512, args.max_candidates,
                spacing=25_000, active_every=48,
                fs=20_000_000, base=118_500_000, chan_impl="pfb",
                block_seconds=args.band_core,
                compute=args.compute, sync_impl="stream",
            )
        except Exception as e:
            print(f"# whole-band config failed: {e}", file=sys.stderr)
            extra["scale_band_760ch"] = {"error": str(e)}
        if (args.device
                and time.perf_counter() - t_start < band_cutoff
                and "error" not in extra["scale_band_760ch"]):
            # chip-bound band point: one 0.5 s (760ch, 20 Msps) block
            # staged on device, 2x2 decodes, checksum-only fetch
            try:
                extra["device_band_760ch"] = run_device_config(
                    760, 1.0, 3, 2, 512, args.max_candidates,
                    spacing=25_000, active_every=48, fs=20_000_000,
                    base=118_500_000, chan_impl="pfb",
                    compute=args.compute, sync_impl="stream",
                    probe_seconds=args.band_core,
                )
            except Exception as e:
                print(f"# device band leg failed: {e}", file=sys.stderr)
                extra["device_band_760ch"] = {"error": str(e)}
    kchan_cutoff = min(args.budget_s, args.kchan_budget_s)
    kchan = args.kchan if args.kchan is not None else not args.quick
    if kchan and time.perf_counter() - t_start > kchan_cutoff:
        print(f"# past kchan budget ({kchan_cutoff:.0f}s), skipping "
              "2000-channel config", file=sys.stderr)
        extra["scale_2000ch"] = {
            "skipped": f"past kchan budget ({kchan_cutoff:.0f}s)"}
    elif kchan:
        try:
            # 2000 channels x 25 kHz = a 50 MHz plan inside a synthetic
            # 100 Msps capture (physical VDL tops out at 760 channels;
            # this is the channel-count scaling endpoint, not a real
            # band).  active_every=100 puts bursts on 20 channels
            # including both plan edges (the highest-|offset| LOs, where
            # a channelizer/decimation defect would show first) so the
            # recall gate means something at this shape.
            extra["scale_2000ch"] = run_config(
                2000, 0.25, 2, 512, args.max_candidates,
                spacing=25_000, active_every=100,
                fs=100_000_000, base=1_118_500_000, chan_impl="pfb",
                compute=args.compute, sync_impl="stream",
            )
        except Exception as e:
            print(f"# 2000ch config failed: {e}", file=sys.stderr)
            extra["scale_2000ch"] = {"error": str(e)}
    lat_points = ((0.1, 0.25, 0.5, 1.0) if args.latency == "all"
                  else () if args.latency == "off" else (0.1, 0.25))
    if lat_points and time.perf_counter() - t_start > args.budget_s:
        print("# budget exceeded, skipping latency mode", file=sys.stderr)
        extra["latency"] = {"skipped": "past budget"}
    elif lat_points:
        try:
            # the floor first: each latency point is block-period +
            # pipeline turnaround, and turnaround bottoms out at the
            # per-fetch round trip — report both so the p50s are
            # attributable (fetch floor vs device vs block period)
            extra["link_floor"] = measure_link_floor()
            extra["latency"] = [run_latency(bs) for bs in lat_points]
        except Exception as e:
            print(f"# latency mode failed: {e}", file=sys.stderr)
            extra["latency"] = {"error": str(e)}
    # the 64/76ch dft scaling legs run LAST: on a cold-compile run the
    # compiles can eat the whole budget, and the headline band/kchan/
    # latency evidence must not be what gets budget-skipped
    if args.scale:
        # both scale configs use 25 kHz spacing: at 50 kHz, 64 channels span 3.2 MHz
        # > the 2 Msps Nyquist and alias onto each other (the round-2
        # "143 frames from 98 bursts" anomaly; make_capture now rejects
        # any aliasing plan outright).  Active channels sit 125 kHz apart:
        # the 84 kHz decimation folds a neighbour at offset S to |S mod 84|
        # kHz, and 125 kHz folds to 41 kHz — maximally far from the matched
        # filter (100 kHz folds to 16 kHz and corrupts marginal bursts
        # through the reference-parity boxcar)
        for ch, sec, it, sp, act in ((64, 1.0, 4, 25_000, 5),
                                     (76, 1.0, 4, 25_000, 5)):
            if time.perf_counter() - t_start > args.budget_s:
                print(f"# budget exceeded, skipping {ch}ch", file=sys.stderr)
                continue
            try:
                extra[f"scale_{ch}ch"] = run_config(
                    ch, sec, it, args.max_symbols, args.max_candidates,
                    spacing=sp, active_every=act, chan_impl="dft",
                    compute=args.compute, sync_impl=args.sync_impl,
                )
            except Exception as e:          # never lose the primary metric
                print(f"# {ch}ch config failed: {e}", file=sys.stderr)
                extra[f"scale_{ch}ch"] = {"error": str(e)}
    if args.analysis:
        try:
            extra["analysis"] = run_analysis(
                args.seconds, args.iters, args.max_symbols,
                compute=args.compute, sync_impl=args.sync_impl)
        except Exception as e:
            print(f"# analysis failed: {e}", file=sys.stderr)

    extra["stimulus"] = ("impaired: per-burst CFO uniform ±400 Hz "
                         "(±3 ppm), 18 dB near-far level spread (1-8 u8 "
                         "LSB), random carrier phase + fractional-sample "
                         "timing (recall gate covers the sync/CFO/timing "
                         "estimators)")
    full = {
        "metric": "wideband_iq_decode_throughput",
        "value": primary["msps"],
        "unit": "Msamples/s/chip",
        "vs_baseline": round(primary["msps"] / 2.0, 2),
    }
    if extra:
        full["extra"] = extra
    # The FULL record goes to stderr and bench_full.json; stdout gets ONE
    # COMPACT line (<~600 chars) with the headline + a summary of every
    # major leg, so a reader of the output's tail always finds it.
    print(f"# full {json.dumps(full)}", file=sys.stderr)
    try:
        with open("bench_full.json", "w") as fh:
            json.dump(full, fh, indent=1)
    except OSError:
        pass
    summary: dict = {}

    def _leg(name, src, *fields):
        if not isinstance(src, dict):
            return
        vals = {k: src[k] for k in fields if k in src}
        if "error" in src:
            vals["error"] = str(src["error"])[:60]
        if "skipped" in src:
            vals["skipped"] = True
        if vals:
            summary[name] = vals

    summary["recall"] = primary.get("recall")
    _leg("dev8", extra.get("device_8ch", {}), "device_msps",
         "device_msps_passes", "channelizer_mfu_vs_matmul_peak",
         "matmul_peak_gflops_f32", "hbm_read_gbps")
    _leg("band", extra.get("scale_band_760ch", {}), "msps",
         "channel_realtime_equivalents", "recall")
    _leg("devband", extra.get("device_band_760ch", {}), "device_msps",
         "device_msps_passes", "channelizer_mfu_vs_matmul_peak")
    _leg("kchan", extra.get("scale_2000ch", {}), "msps",
         "channel_realtime_equivalents", "recall")
    lats = extra.get("latency")
    if isinstance(lats, list):
        summary["lat"] = [
            {k: p[k] for k in
             ("block_seconds", "p50_ms", "sustained") if k in p}
            for p in lats if isinstance(p, dict)]
    out = dict(full)
    out["extra"] = {"summary": summary, "full": "stderr + bench_full.json"}
    line = json.dumps(out, separators=(",", ":"))
    if len(line) > 1500:        # never outgrow the tail window again
        out["extra"] = {"full": "stderr + bench_full.json"}
        line = json.dumps(out, separators=(",", ":"))
    print(line)


if __name__ == "__main__":
    main()
