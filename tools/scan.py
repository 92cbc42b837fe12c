#!/usr/bin/env python
"""Frequency scan: find active VDL-M2 channels in a wideband capture.

Accelerator equivalent of the reference's scan.sh (which retunes a live dongle 4
frequencies at a time and tallies log lines).  Here the batched channelizer
decodes EVERY 25 kHz channel in the captured span simultaneously and reports
per-frequency message counts.

Usage:
  python tools/scan.py --iq cap.cu8 --fs 2000000 --fc 136900000 \
      [--start 136.0] [--stop 137.0] [--format cu8]
"""
from __future__ import annotations

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from vdlm2dec_tpu.constants import STEPRATE  # noqa: E402
from vdlm2dec_tpu.io.sdr import read_capture  # noqa: E402
from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iq", required=True)
    ap.add_argument("--format", default="cu8")
    ap.add_argument("--fs", type=int, default=2_000_000)
    ap.add_argument("--fc", type=float, required=True)
    ap.add_argument("--start", type=float, default=None, help="MHz")
    ap.add_argument("--stop", type=float, default=None, help="MHz")
    ap.add_argument("--max-rows", type=int, default=4)
    ap.add_argument("--block-seconds", type=float, default=1.0,
                    help="stream the capture in blocks of this length "
                         "(short blocks bound device memory at whole-span "
                         "channel counts)")
    ap.add_argument("--chan-impl", default=None,
                    choices=("matmul", "dft", "pfb"),
                    help="channelizer (default: residue-space dft when fc "
                         "sits on the 25 kHz raster, else matmul)")
    args = ap.parse_args()

    from vdlm2dec_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    guard = 2 * STEPRATE
    lo = args.fc - args.fs / 2 + guard
    hi = args.fc + args.fs / 2 - guard
    if args.start is not None:
        lo = max(lo, args.start * 1e6)
    if args.stop is not None:
        hi = min(hi, args.stop * 1e6)
    first = int(np.ceil(lo / STEPRATE)) * STEPRATE
    freqs = [float(f) for f in range(first, int(hi), STEPRATE)
             if abs(f - args.fc) >= guard]
    print(f"# scanning {len(freqs)} channels "
          f"{freqs[0] / 1e6:.3f}..{freqs[-1] / 1e6:.3f} MHz", file=sys.stderr)

    chan_impl = args.chan_impl
    if chan_impl is None:
        # the residue-space channelizer needs raster-aligned offsets
        # (what chooseFc produces); fall back for off-raster fc
        on_raster = all((f - args.fc) % STEPRATE == 0 for f in freqs)
        chan_impl = "dft" if on_raster else "matmul"
    cfg = PipelineConfig(
        freqs_hz=freqs, fs=args.fs, fc_hz=args.fc,
        max_symbols=args.max_rows * 680 + 16, max_candidates=16,
        chan_impl=chan_impl,
    )
    pipe = Pipeline(cfg)
    x = read_capture(args.iq, args.format)

    counts: dict[float, int] = {f: 0 for f in freqs}
    for bursts in pipe.stream_wideband(x, block_seconds=args.block_seconds):
        for b in bursts:
            if b.frames:
                counts[b.freq_hz] += len(b.frames)

    for f in sorted(counts, key=lambda f: -counts[f]):
        if counts[f]:
            print(f"{f / 1e6:.3f} MHz: {counts[f]} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
