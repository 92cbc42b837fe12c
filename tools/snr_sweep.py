#!/usr/bin/env python
"""SNR sweep harness (BASELINE config 4): decode rate vs SNR, 2-20 dB.

Synthesizes bursts at controlled SNR/CFO/timing and reports frame decode
probability per SNR point for the device pipeline (optionally also the golden
scalar oracle for comparison).

Usage: python tools/snr_sweep.py [--trials 20] [--golden] [--snrs 2 4 ... 20]
"""
from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--snrs", type=float, nargs="*",
                    default=[2, 3, 4, 5, 6, 8, 10, 14, 20])
    ap.add_argument("--golden", action="store_true",
                    help="also run the scalar oracle")
    ap.add_argument("--payload", type=int, default=40)
    args = ap.parse_args()

    from vdlm2dec_tpu import modulator as mod
    from vdlm2dec_tpu.golden.codec import deframe_block
    from vdlm2dec_tpu.golden.dsp import GoldenChannel
    from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig

    cfg = PipelineConfig(freqs_hz=[136_975_000.0], fc_hz=136_900_000.0,
                         max_symbols=1024, max_candidates=8)
    pipe = Pipeline(cfg)
    rng = np.random.default_rng(0)

    rows = []
    for snr in args.snrs:
        ok_t = ok_g = 0
        for trial in range(args.trials):
            content = rng.integers(0, 256, args.payload).astype(np.uint8)
            plan = mod.make_burst([content])
            sig = mod.synthesize_baseband(
                plan, start=400, total=3000,
                timing_frac=float(rng.random()),
                cfo_hz=float(rng.normal(0, 100)),
            )
            sig = mod.awgn(sig, snr, rng)
            bursts = pipe.decode_channels(sig[None, :].astype(np.complex64))
            if any(np.array_equal(f[1:-3], content)
                   for b in bursts for f in b.frames):
                ok_t += 1
            if args.golden:
                gch = GoldenChannel()
                for b in gch.run(sig):
                    fr, _ = deframe_block(b.block, b.nbrow, b.nlbyte)
                    if any(np.array_equal(f[1:-3], content) for f in fr):
                        ok_g += 1
                        break
        row = {"snr_db": snr, "device_rate": round(ok_t / args.trials, 3)}
        if args.golden:
            row["golden_rate"] = round(ok_g / args.trials, 3)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
