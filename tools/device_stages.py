"""Device-resident per-stage timing of the production decode program.

Runs cumulative truncations of the REAL fused decode (pipeline
make_device_probe(probe_stage=...)) under the salt-loop/scalar-fetch
trick, so each timing is device time with upload, fetch and host decode
out of the loop.  The delta between consecutive stages localizes where
device time goes.

Usage (on the GPU):
    python tools/device_stages.py --channels 8 --seconds 4
    python tools/device_stages.py --band          # 760ch pfb shape
Writes one JSON line with cumulative and delta ms per stage.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


STAGES = ["channelize", "filter", "sync", "triggers", "demod",
          "header", "assemble", None]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--inner", type=int, default=4)
    ap.add_argument("--outer", type=int, default=3)
    ap.add_argument("--chan-impl", default="auto")
    ap.add_argument("--compute", default="f32")
    ap.add_argument("--sync-impl", default="stream")
    ap.add_argument("--max-symbols", type=int, default=2048)
    ap.add_argument("--band", action="store_true",
                    help="whole-band shape: 760ch pfb, 20 Msps, "
                         "0.5 s probe block")
    ap.add_argument("--stages", default=None,
                    help="comma list to probe (default: all for the "
                         "sync impl)")
    args = ap.parse_args()

    from vdlm2dec_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    import bench
    import jax
    import jax.numpy as jnp

    from vdlm2dec_tpu.pipeline import (
        Pipeline,
        PipelineConfig,
        make_device_probe,
    )

    if args.band:
        fs, channels, seconds = 20_000_000, 760, 1.0
        spacing, active_every, base = 25_000, 48, 118_500_000
        chan_impl, sync_impl, max_symbols = "pfb", "stream", 512
        probe_seconds = 0.5
    else:
        fs, channels, seconds = 2_000_000, args.channels, args.seconds
        spacing, active_every, base = 50_000, 1, None
        chan_impl, sync_impl = args.chan_impl, args.sync_impl
        max_symbols = args.max_symbols
        probe_seconds = None

    wide, freqs, fc, _truth = bench.make_capture(
        fs, channels, seconds, spacing=spacing, active_every=active_every,
        base=base)
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=fs, fc_hz=float(fc),
        lo_wrap=True,
        max_candidates=max(16, int(16 * seconds)),
        max_symbols=max_symbols,
        chan_impl=chan_impl, compute=args.compute, sync_impl=sync_impl,
        max_out=max(64, int(22 * seconds * channels
                            // max(active_every, 1))),
    )
    pipe = Pipeline(cfg)
    if probe_seconds is not None:
        wide = wide[: int(probe_seconds * fs)]
    raw_u8 = bench.to_u8(wide)

    if args.stages:
        stages = [s if s != "full" else None
                  for s in args.stages.split(",")]
    else:
        stages = STAGES

    salts = jnp.arange(1, args.inner + 1, dtype=jnp.uint8)
    rows = []
    prev_ms = 0.0
    t = None
    for st in stages:
        name = st or "full"
        try:
            probe, raw_dev, t = make_device_probe(
                pipe, raw_u8, probe_stage=st)
            t0 = time.perf_counter()
            r = probe(raw_dev, salts)
            jax.block_until_ready(r)
            compile_s = time.perf_counter() - t0
            best = float("inf")
            for i in range(args.outer):
                t0 = time.perf_counter()
                jax.block_until_ready(probe(raw_dev, salts + jnp.uint8(i)))
                best = min(best, time.perf_counter() - t0)
            ms = best / args.inner * 1e3
            rows.append({"stage": name, "cum_ms": round(ms, 2),
                         "delta_ms": round(ms - prev_ms, 2),
                         "compile_s": round(compile_s, 1)})
            prev_ms = ms
            print(f"# {name}: {ms:.2f} ms cumulative "
                  f"(+{rows[-1]['delta_ms']:.2f}), compile "
                  f"{compile_s:.0f}s", file=sys.stderr)
        except Exception as e:
            rows.append({"stage": name, "error": str(e)[:200]})
            print(f"# {name}: FAILED {e}", file=sys.stderr)
    out = {"config": {"channels": channels, "fs": fs,
                      "block_samples": t,
                      "chan_impl": pipe.cfg.chan_impl,
                      "sync_impl": pipe.cfg.sync_impl,
                      "compute": pipe.cfg.compute,
                      "max_symbols": max_symbols,
                      "max_out": pipe._max_out(),
                      "inner": args.inner, "outer": args.outer},
           "stages": rows}
    if t:
        full = next((r for r in rows if r["stage"] == "full"
                     and "cum_ms" in r), None)
        if full:
            out["device_msps"] = round(t / full["cum_ms"] / 1e3, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
