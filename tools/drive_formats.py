"""Drive every raw capture format through the CLI at production shape.

Device-only failure modes (out of device memory, compile failures,
compile times) are invisible to every CPU test, so each ingest format
must run on the GPU at its production shape (full 8-row demod window,
4 s streaming blocks) at least once.  This tool synthesizes a multi-burst ACARS capture per
format (cu8 / cs16 / cf32 at 2 Msps complex, f32real at the Airspy
Mini's 6 Msps and R2's 5 Msps real chains, air.c:123-141), runs the
ACTUAL CLI (`python -m vdlm2dec_tpu.cli`) on it, and asserts that every
synthesized burst's text comes back.

Runs on the default JAX backend (the GPU where there is one); each
format compiles its own program the first time.  Exit code 0 = all
formats green.

Usage: python tools/drive_formats.py [--formats cu8,cs16,cf32,f32real5,f32real6]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TWO_PI = 2 * np.pi


def synth_complex(path: str, fmt: str, fs: int, seconds: float,
                  n_channels: int = 8):
    """Multi-channel ACARS capture in a complex format; returns (freqs,
    fc, texts)."""
    from vdlm2dec_tpu import framegen as fg
    from vdlm2dec_tpu import modulator as mod
    from vdlm2dec_tpu.constants import DEMOD_RATE
    from vdlm2dec_tpu.io.sdr import write_capture

    rng = np.random.default_rng(7)
    freqs = [136_600_000 + 50_000 * i for i in range(n_channels)]
    fc = 136_775_000
    total = int(fs * seconds)
    total_bb = int(DEMOD_RATE * seconds)
    wide = np.zeros(total, dtype=np.complex128)
    texts = []
    for ci, f in enumerate(freqs):
        bb = np.zeros(total_bb, dtype=np.complex128)
        pos = 700 + 1131 * ci
        k = 0
        while pos + 6000 < total_bb:
            text = f"{fmt.upper()}C{ci}N{k:02d}"
            content = fg.acars_frame(text=text, label="Q0")
            burst = mod.synthesize_baseband(
                mod.make_burst([content]), start=0, total=None,
                cfo_hz=float(rng.uniform(-400, 400)),
                phase0=float(rng.uniform(0, TWO_PI)),
                timing_frac=float(rng.uniform(0, 1)),
                amplitude=float(8.0 * 10 ** (rng.uniform(-18, 0) / 20)),
            )
            if pos + len(burst) > total_bb:
                break
            bb[pos : pos + len(burst)] += burst
            texts.append(text)
            # gap keeps <=28 bursts/channel per 4 s window: the CLI's
            # per-channel sync-candidate capacity is 32/block
            # (PipelineConfig.max_candidates); this tool drives
            # production shape, not slot-overflow (which warns)
            pos += len(burst) + int(rng.integers(6500, 16000))
            k += 1
        wide += mod.upsample_to_wideband(bb, fs, f - fc, total=total)
    noise = rng.normal(size=total) + 1j * rng.normal(size=total)
    wide = wide + 0.02 * noise
    if fmt == "cs16":
        wide = wide * 256.0          # use the int16 range like a real SDR
    write_capture(path, wide.astype(np.complex64), fmt)
    return freqs, fc, texts


def synth_real(path: str, fs: int, seconds: float):
    """Airspy-chain real capture: channels mixed relative to F0 = fc +
    fs/4 (air.c:182-185); returns (freqs, fc, texts)."""
    from vdlm2dec_tpu import framegen as fg
    from vdlm2dec_tpu import modulator as mod
    from vdlm2dec_tpu.constants import DEMOD_RATE

    rng = np.random.default_rng(11)
    # fc such that F0 and all channels stay inside the valid 118-138 MHz
    # band (the CLI drops out-of-band frequencies, reference parity)
    fc = 136_000_000 - fs // 4
    f0 = fc + fs // 4
    # four channels on the 25 kHz raster spread across the usable band.
    # The synthetic real model places channel energy at +fo with a
    # conjugate image at -fo (test_airspy_e2e.py), so offsets must have
    # pairwise-distinct |fo| (else one channel's image lands ON another)
    # and |fo| large enough that a channel clears its own image
    freqs = [int(round((f0 + off) / 25_000)) * 25_000
             for off in (-1_200_000, -500_000, 250_000, 900_000)]
    total = int(fs * seconds)
    total_bb = int(DEMOD_RATE * seconds)
    real_sig = np.zeros(total, dtype=np.float64)
    texts = []
    ratio = fs / DEMOD_RATE
    for ci, f in enumerate(freqs):
        bb = np.zeros(total_bb, dtype=np.complex128)
        pos = 700 + 1409 * ci
        k = 0
        while pos + 6000 < total_bb:
            text = f"AIR{fs // 1_000_000}C{ci}N{k:02d}"
            content = fg.acars_frame(text=text, label="Q0")
            burst = mod.synthesize_baseband(
                mod.make_burst([content]), start=0, total=None,
                cfo_hz=float(rng.uniform(-400, 400)),
                phase0=float(rng.uniform(0, TWO_PI)),
                timing_frac=float(rng.uniform(0, 1)),
                amplitude=float(10 ** (rng.uniform(-12, 0) / 20)),
            )
            if pos + len(burst) > total_bb:
                break
            bb[pos : pos + len(burst)] += burst
            texts.append(text)
            # gap keeps <=28 bursts/channel per 4 s window: the CLI's
            # per-channel sync-candidate capacity is 32/block
            # (PipelineConfig.max_candidates); this tool drives
            # production shape, not slot-overflow (which warns)
            pos += len(burst) + int(rng.integers(6500, 16000))
            k += 1
        # Re{a(t) e^{j 2 pi fo t}} * 2: channel at fo relative to F0,
        # conjugate image at -fo (outside the per-channel passband)
        n = total
        tt = np.arange(n) / ratio
        i0 = np.clip(np.floor(tt).astype(int), 0, len(bb) - 2)
        frac = tt - i0
        up = bb[i0] * (1 - frac) + bb[i0 + 1] * frac
        fo = f - f0
        real_sig += 2.0 * np.real(
            up * np.exp(1j * TWO_PI * fo / fs * np.arange(n)))
    real_sig = real_sig * 30 + rng.normal(size=total)
    real_sig.astype(np.float32).tofile(path)
    return freqs, fc, texts


def drive(fmt: str, path: str, freqs, fc, texts, extra_args=(),
          cpu: bool = False) -> dict:
    cmd = [sys.executable, "-m", "vdlm2dec_tpu.cli",
           *[f"{f / 1e6:.6f}" for f in freqs],
           "--iq", path, "--format", fmt, "--fc", str(fc), "-J"]
    cmd += list(extra_args)
    t0 = time.monotonic()
    # smoke mode: force the CPU backend in the child
    env = dict(os.environ, JAX_PLATFORMS="cpu") if cpu else None
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600,
                       env=env)
    wall = time.monotonic() - t0
    got = set()
    for line in r.stdout.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            j = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "text" in j:
            got.add(j["text"].strip())
    missing = [t for t in texts if t not in got]
    return {"fmt": fmt, "wall_s": round(wall, 1), "rc": r.returncode,
            "bursts": len(texts), "decoded": len(texts) - len(missing),
            "missing": missing,
            "stderr_tail": r.stderr.strip().splitlines()[-2:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--formats", default="cu8,cs16,cf32,f32real5,f32real6")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="smoke mode: run the CLI on the CPU backend")
    ap.add_argument("--cli-args", default="",
                    help="extra CLI args, space-separated (e.g. "
                         "'--max-rows 2' for a fast-compile smoke)")
    args = ap.parse_args()

    cli_extra = tuple(args.cli_args.split()) if args.cli_args else ()
    results = []
    for spec in args.formats.split(","):
        if spec.startswith("f32real"):
            fs = {"f32real5": 5_000_000, "f32real6": 6_000_000}[spec]
            path = f"/tmp/drive_{spec}.f32"
            freqs, fc, texts = synth_real(path, fs, args.seconds)
            res = drive("f32real", path, freqs, fc, texts,
                        extra_args=("--fs", str(fs)) + cli_extra,
                        cpu=args.cpu)
            res["fs"] = fs
        else:
            path = f"/tmp/drive_{spec}.bin"
            freqs, fc, texts = synth_complex(
                path, spec, 2_000_000, args.seconds, args.channels)
            res = drive(spec, path, freqs, fc, texts,
                        extra_args=cli_extra, cpu=args.cpu)
        results.append(res)
        print(json.dumps(res), flush=True)
    bad = [r for r in results if r["missing"] or r["rc"]]
    print(f"# {len(results) - len(bad)}/{len(results)} formats green",
          file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
