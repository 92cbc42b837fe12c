#!/usr/bin/env python
"""Recall soak: dense multi-channel traffic through our decoder AND the
compiled reference binary (tests/refshim, unmodified sources); compares
decoded-frame sets and asserts ours is a strict superset.

Scenarios (--scenario):
  clean   2 ch x 10 s, clean bursts (the round-2 artifact: measured
          reference 122/125, ours 125/125 strict superset; --dft
          identical).  The 3 extra frames are bursts arriving shortly
          after a previous burst ends: the serial reference re-enters
          sync search with a stale frozen phase ring (d8psk.c Ph is not
          updated during a burst) and misses them.
  cfo     8 ch x 30 s, per-burst CFO +-2 ppm of the RF channel
          (~ +-274 Hz), 12 dB level spread, random phase + fractional
          timing — the sync/CFO/timing estimators under load, both
          decoders on identical samples.
  airspy  4 ch x 30 s real f32 capture at 5 Msps (R2 chain; --rate
          6000000 for the Mini) through ref_shim_air vs our
          real_input pipeline.

Common flags: --dft/--pfb (residue channelizers), --stream (streaming
sync), --bf16, --seconds/--channels overrides, --json OUT.
Exit code: 0 iff ours >= reference on the common key set (strict
superset) AND ours missed no reference frame.
"""
import sys
sys.path.insert(0, ".")
import argparse
import io
import json
import subprocess
import time

import numpy as np

from vdlm2dec_tpu import modulator as mod, framegen as fg
from vdlm2dec_tpu.host.decoder import FrameDecoder
from vdlm2dec_tpu.host.output import OutputConfig
from vdlm2dec_tpu.io.sdr import write_capture
from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig

TWO_PI = 2 * np.pi


def synth(scenario: str, fs: int, fc: int, freqs: list[int], seconds: int,
          rng, impair_ppm: float = 0.0, spread_db: float = 0.0,
          truth: list | None = None):
    """Complex wideband capture + burst count.  Impairments are per
    burst: CFO uniform +-ppm of the RF channel, level uniform in
    [-spread_db, 0] above the base amplitude, random carrier phase and
    fractional-sample timing.

    truth (optional list) receives one record per burst — channel index,
    position/length at 84 kHz, and the drawn impairments — WITHOUT
    consuming any extra rng draws, so a recorded run is sample-identical
    to an unrecorded one (tools/ref_miss_analysis.py replays misses)."""
    total = fs * seconds
    total_bb = 84_000 * seconds
    wide = np.zeros(total, dtype=np.complex128)
    n_tx = 0
    for ci, f in enumerate(freqs):
        bb = np.zeros(total_bb, dtype=np.complex128)
        pos = 1000 + 7000 * ci
        while pos + 4000 < total_bb:
            txt = f"SOAK {ci} {pos}"
            content = fg.acars_frame(
                text=txt, label="Q0",
                from_addr=fg.AIRCRAFT | (0x100000 + ci * 4096 + (pos & 0xFFF)),
            )
            plan = mod.make_burst([content])
            if impair_ppm or spread_db:
                imp = dict(
                    cfo_hz=float(rng.uniform(-impair_ppm, impair_ppm)
                                 * f / 1e6),
                    phase0=float(rng.uniform(0, TWO_PI)),
                    timing_frac=float(rng.uniform(0, 1)),
                    amplitude=float(10 ** (rng.uniform(-spread_db, 0) / 20)),
                )
                burst = mod.synthesize_baseband(plan, start=0, **imp)
            else:
                imp = {}
                burst = mod.synthesize_baseband(plan, start=0)
            if pos + len(burst) > total_bb:
                break
            bb[pos : pos + len(burst)] += burst
            n_tx += 1
            if truth is not None:
                truth.append({"ci": ci, "freq": f, "pos": pos,
                              "len": len(burst), "text": txt, **imp})
            pos += len(burst) + int(rng.integers(3000, 20000))
        wide += mod.upsample_to_wideband(bb, fs, f - fc, total=total)
    return wide, n_tx


def synth_real(fs: int, f0: float, freqs: list[int], seconds: int, rng,
               impair_ppm: float, spread_db: float):
    """Airspy-chain real capture (channel energy at fo = f - f0 with the
    conjugate image at -fo; offsets chosen with distinct |fo|)."""
    total = fs * seconds
    total_bb = 84_000 * seconds
    real_sig = np.zeros(total, dtype=np.float64)
    ratio = fs / 84_000
    n_tx = 0
    for ci, f in enumerate(freqs):
        bb = np.zeros(total_bb, dtype=np.complex128)
        pos = 1000 + 7000 * ci
        while pos + 4000 < total_bb:
            txt = f"SOAK {ci} {pos}"
            content = fg.acars_frame(
                text=txt, label="Q0",
                from_addr=fg.AIRCRAFT | (0x100000 + ci * 4096 + (pos & 0xFFF)),
            )
            plan = mod.make_burst([content])
            burst = mod.synthesize_baseband(
                plan, start=0,
                cfo_hz=float(rng.uniform(-impair_ppm, impair_ppm) * f / 1e6),
                phase0=float(rng.uniform(0, TWO_PI)),
                timing_frac=float(rng.uniform(0, 1)),
                amplitude=float(10 ** (rng.uniform(-spread_db, 0) / 20)),
            )
            if pos + len(burst) > total_bb:
                break
            bb[pos : pos + len(burst)] += burst
            n_tx += 1
            pos += len(burst) + int(rng.integers(3000, 20000))
        tt = np.arange(total) / ratio
        i0 = np.clip(np.floor(tt).astype(int), 0, len(bb) - 2)
        frac = tt - i0
        up = bb[i0] * (1 - frac) + bb[i0 + 1] * frac
        fo = f - f0
        real_sig += 2.0 * np.real(
            up * np.exp(1j * TWO_PI * fo / fs * np.arange(total)))
    return real_sig, n_tx


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="clean",
                    choices=("clean", "cfo", "airspy"))
    ap.add_argument("--seconds", type=int, default=None)
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--rate", type=int, default=5_000_000,
                    help="airspy scenario sample rate (5000000 R2 / "
                         "6000000 Mini)")
    ap.add_argument("--dft", action="store_true")
    ap.add_argument("--pfb", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="sync_impl=stream (the product default)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--json", default=None, help="write a summary JSON")
    ap.add_argument("--cpu", action="store_true",
                    help="run our side on the CPU backend (smoke mode)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    rng = np.random.default_rng(42)
    if args.scenario == "airspy":
        fs = args.rate
        seconds = args.seconds or 30
        fc = 136_000_000 - fs // 4
        f0 = fc + fs // 4
        nch = args.channels or 4
        # distinct |fo| (see tools/drive_formats.py: the synthetic real
        # model has a conjugate image at -fo)
        offs = (-1_200_000, -500_000, 250_000, 900_000,
                -1_500_000, 650_000, -850_000, 1_100_000)[:nch]
        freqs = [int(round((f0 + o) / 25_000)) * 25_000 for o in offs]
        sig, n_tx = synth_real(fs, f0, freqs, seconds, rng,
                               impair_ppm=2.0, spread_db=12.0)
        sig = sig * 30 + rng.normal(size=len(sig))
        path = "/tmp/soak_air.f32"
        sig.astype(np.float32).tofile(path)
        ref_cmd = (["/root/repo/tests/refshim/ref_shim_air", path, str(fc)]
                   + [f"{f / 1e6:.6f}" for f in freqs]
                   + ["-J", f"-r{fs}"])
    else:
        fs = 2_000_000
        seconds = args.seconds or (10 if args.scenario == "clean" else 30)
        fc = 136_900_000 if args.scenario == "clean" else 136_775_000
        if args.scenario == "clean":
            freqs = [136_725_000, 136_975_000][: args.channels or 2]
        else:
            nch = args.channels or 8
            freqs = [136_600_000 + 50_000 * i for i in range(nch)]
        ppm = 0.0 if args.scenario == "clean" else 2.0
        spread = 0.0 if args.scenario == "clean" else 12.0
        wide, n_tx = synth(args.scenario, fs, fc, freqs, seconds, rng,
                           impair_ppm=ppm, spread_db=spread)
        wide *= 40.0
        wide += rng.normal(size=len(wide)) + 1j * rng.normal(size=len(wide))
        path = "/tmp/soak.cu8"
        write_capture(path, wide, "cu8")
        ref_cmd = (["/root/repo/tests/refshim/ref_shim", path, str(fc)]
                   + [f"{f / 1e6:.6f}" for f in freqs] + ["-J"])
    print(f"capture: {args.scenario}, {seconds}s x {len(freqs)}ch, "
          f"{n_tx} bursts", flush=True)

    r = subprocess.run(ref_cmd, capture_output=True, text=True, timeout=1800)
    ref = [json.loads(l) for l in r.stdout.splitlines()
           if l.strip().startswith("{")]
    print(f"reference decoded: {len(ref)}", flush=True)

    impl = "dft" if args.dft else ("pfb" if args.pfb else "matmul")
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=fs, fc_hz=float(fc),
        real_input=(args.scenario == "airspy"),
        # capacity: ~25 bursts/channel per 4 s block at this stimulus
        # density, x2 headroom for garbage triggers (slots are consumed
        # per sync candidate, not per valid frame)
        max_symbols=1024, max_candidates=64, chan_impl=impl,
        sync_impl="stream" if args.stream else "xla",
        compute="bf16" if args.bf16 else "f32",
        max_out=max(96, 56 * len(freqs)))
    pipe = Pipeline(cfg)
    buf = io.StringIO()
    dec = FrameDecoder(OutputConfig(verbose=0, jsonout=True, logfile=buf))
    t0 = time.time()
    if args.scenario == "airspy":
        from vdlm2dec_tpu.io.sdr import CaptureReader

        raw = CaptureReader(path, "f32real").raw
        stream = pipe.stream_wideband_u8(raw, block_seconds=4.0,
                                         fmt="f32real")
    else:
        raw = np.fromfile(path, dtype=np.uint8)
        stream = pipe.stream_wideband_u8(raw, block_seconds=4.0)
    for bursts in stream:
        for b in bursts:
            dec.process_burst(b)
    dt = time.time() - t0
    ours = [json.loads(l) for l in buf.getvalue().splitlines() if l.strip()]
    print(f"ours decoded: {len(ours)} in {dt:.1f}s", flush=True)

    def key(o):
        return (o["freq"], o.get("text"), o.get("hex"))

    kr, ko = set(map(key, ref)), set(map(key, ours))
    both = len(kr & ko)
    superset = kr <= ko
    print(f"tx={n_tx} ref={len(kr)} ours={len(ko)} common={both} "
          f"strict_superset={superset}", flush=True)
    print("only-ref:", sorted(kr - ko)[:5], flush=True)
    print("only-ours:", sorted(ko - kr)[:5], flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"scenario": args.scenario, "seconds": seconds,
                       "channels": len(freqs), "tx": n_tx,
                       "ref": len(kr), "ours": len(ko), "common": both,
                       "strict_superset": superset,
                       "impl": impl, "fs": fs}, f, indent=1)
    return 0 if superset else 1


if __name__ == "__main__":
    sys.exit(main())
