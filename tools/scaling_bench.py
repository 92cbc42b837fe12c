"""Measured multi-host scaling over the real cross-process path (Gloo, CPU).

Runs the multihost worker (parallel/multihost.py: jax.distributed + Gloo
collectives between real processes) over a FIXED capture at 1..N
processes, each pinned to its own disjoint CPU core set via taskset so
that P processes honestly emulate P single-host machines.  Window 0 of
each run carries the compile and is excluded; throughput is global
capture samples per post-warmup wall second, taken from process 0 (the
shard_map step is a collective, so all processes advance in lockstep).

Every run also cross-checks correctness: the union of FRAME lines must
be identical across all process counts.

Writes a JSON artifact (default SCALING_MEASURED.json) with per-P
throughput and parallel efficiency vs P=1:
    eff(P) = throughput(P) / (P * throughput(1))

This machine has very few cores, so the curve stops at
cores-available; the point of the artifact is a MEASURED efficiency on
the genuine cross-process code path, not a big-iron number (SCALING.md carries
the cost model for real pods).

Usage: python tools/scaling_bench.py [--seconds 8] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth_capture(path: str, fs: int, channels: int, seconds: float):
    """Fixed stimulus via the bench generator; returns truth list."""
    import bench as bench_mod

    wide, freqs, fc, truth = bench_mod.make_capture(
        fs, channels, seconds)
    bench_mod.to_u8(wide).tofile(path)
    return freqs, fc, truth


def run_p(processes: int, capture: str, freqs_mhz: list[float], fc: int,
          block_seconds: float, cores: int, devices_per_proc: int,
          timeout: float, dispatch_depth: int = 2) -> dict:
    from vdlm2dec_tpu.parallel.multihost import launch_local

    if processes <= cores:
        # honest emulation: P disjoint core sets = P single-host machines
        per: float = cores // processes
        cpu_sets = [
            ",".join(str(c) for c in range(p * int(per), (p + 1) * int(per)))
            for p in range(processes)
        ]
        pinned = True
    else:
        # oversubscribed (P > physical cores): processes share the
        # machine unpinned; cores_per_process is the FRACTIONAL share so
        # the ideal-throughput normalisation stays whole-machine, and the
        # point is labelled — it measures rendezvous/skew behaviour at
        # higher P, not real speedup
        per = cores / processes
        cpu_sets = None
        pinned = False
    worker_args = [
        "--iq", capture, "--fc", str(fc),
        "--block-seconds", str(block_seconds),
        "--max-symbols", "512", "--timing",
        "--dispatch-depth", str(dispatch_depth),
        # capacity sized for the dense stimulus (~76 bursts per 1 s
        # window; the worker defaults overflow and drop bursts, and the
        # loss would differ by P because packed slots are per process)
        "--max-candidates", "32", "--max-out", "256",
    ] + [str(f) for f in freqs_mhz]
    t0 = time.monotonic()
    outs = launch_local(processes, worker_args,
                        local_devices=devices_per_proc, timeout=timeout,
                        cpu_sets=cpu_sets)
    wall = time.monotonic() - t0
    frames = set()
    stats = None
    for out in outs:
        for line in out.splitlines():
            if line.startswith("FRAME "):
                frames.add(line)
            elif line.startswith("STATS ") and stats is None:
                stats = json.loads(line[6:])
    if stats is None:
        raise RuntimeError("no STATS line (need >=2 windows for timing)")
    samples = stats["timed_windows"] * stats["global_samples_per_window"]
    msps = samples / stats["timed_s"] / 1e6
    return {
        "processes": processes,
        "cores_per_process": per,
        "pinned": pinned,
        "devices_per_process": devices_per_proc,
        "block_seconds": block_seconds,
        "dispatch_depth": dispatch_depth,
        "timed_windows": stats["timed_windows"],
        "timed_s": round(stats["timed_s"], 3),
        "msps": round(msps, 3),
        "total_wall_s": round(wall, 1),
        "phase_s": stats.get("phase_s", {}),
        "frames": sorted(frames),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--fs", type=int, default=2_000_000)
    ap.add_argument("--block-seconds", default="1.0",
                    help="comma list of window sizes to sweep")
    ap.add_argument("--processes", default=None,
                    help="comma list (default: 1,2,..,cores plus 2*cores "
                         "unpinned)")
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--dispatch-depth", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--repeats", type=int, default=3,
                    help="runs per (P, window) point; best/median/worst "
                         "all recorded (2-core box timing noise is "
                         "+-20%%), efficiency quoted on best AND worst")
    ap.add_argument("--out", default="SCALING_MEASURED.json")
    args = ap.parse_args()

    cores = len(os.sched_getaffinity(0))
    if args.processes:
        plist = [int(x) for x in args.processes.split(",")]
    else:
        plist = [p for p in (1, 2, 4, 8) if p <= cores] + [2 * cores]
    wlist = [float(x) for x in args.block_seconds.split(",")]
    capture = os.path.join("/tmp", f"scaling_{args.fs}_{args.channels}_"
                                   f"{args.seconds}.cu8")
    freqs, fc, truth = synth_capture(capture, args.fs, args.channels,
                                     args.seconds)
    freqs_mhz = [f / 1e6 for f in freqs]
    print(f"# capture: {args.seconds}s x {args.channels}ch, "
          f"{len(truth)} bursts; cores={cores}, P={plist}",
          file=sys.stderr)

    runs = []
    frame_sets = []
    for bs in wlist:
        # INTERLEAVED schedule: rep0 of every P, then rep1 of every P, ...
        # — the box's ambient speed drifts +-20% across minutes, so
        # back-to-back (P=1, P=k) pairs let the drift cancel in the
        # PAIRED efficiency below, which block-ordered repeats cannot
        samples_by_p: dict = {p: [] for p in plist}
        for rep in range(args.repeats):
            for p in plist:
                r = run_p(p, capture, freqs_mhz, fc, bs, cores,
                          args.devices_per_proc, args.timeout,
                          dispatch_depth=args.dispatch_depth)
                print(f"# P={p} w={bs}s rep{rep}: {r['msps']} Msps over"
                      f" {r['timed_windows']} windows"
                      f" ({r['cores_per_process']} cores/proc,"
                      f" {len(r['frames'])} frames)", file=sys.stderr,
                      flush=True)
                frame_sets.append(set(r["frames"]))
                samples_by_p[p].append(r)
        for p in plist:
            samples = sorted(samples_by_p[p], key=lambda r: r["msps"])
            best = dict(samples[-1])
            del best["frames"]
            best["msps_worst"] = samples[0]["msps"]
            best["msps_median"] = samples[len(samples) // 2]["msps"]
            # paired efficiency: rep i of this point vs rep i of the SAME
            # window's P=1 baseline (run back-to-back above) — drift-
            # cancelled; recorded per pair so min/median are honest
            if p != 1 and 1 in samples_by_p:
                pairs = []
                for ri, rb in zip(samples_by_p[p], samples_by_p[1]):
                    base = rb["msps"] / (rb["processes"]
                                         * rb["cores_per_process"])
                    ideal = base * ri["processes"] * ri["cores_per_process"]
                    pairs.append(round(ri["msps"] / ideal, 3))
                best["efficiency_paired"] = sorted(pairs)
            runs.append(best)

    # correctness: identical frame sets at every process count, window
    # size, and repeat (windowing is exact overlap-save; ownership is
    # trigger-position based, so the union must not depend on geometry)
    identical = all(fs_ == frame_sets[0] for fs_ in frame_sets)
    # efficiency vs the P=1 point of the SAME window size, on the
    # core-normalised ideal (P procs x per-proc core share); quote the
    # best-of-repeats AND the worst-of-repeats (the target is a >=0.9
    # WORST case, not a lucky median)
    base_by_w = {r["block_seconds"]: r for r in runs if r["processes"] == 1}
    for r in runs:
        b = base_by_w.get(r["block_seconds"])
        if b is None:
            continue
        base = b["msps"] / (b["processes"] * b["cores_per_process"])
        ideal = base * r["processes"] * r["cores_per_process"]
        r["efficiency_vs_1proc"] = round(r["msps"] / ideal, 3)
        # worst-case pairing: this point's slowest repeat vs the SAME
        # window's fastest P=1 repeat — the harshest honest ratio
        r["efficiency_worst"] = round(r["msps_worst"] / ideal, 3)

    out = {
        "capture_seconds": args.seconds,
        "channels": args.channels,
        "bursts": len(truth),
        "cores_available": cores,
        "dispatch_depth": args.dispatch_depth,
        "frames_identical_across_runs": identical,
        "runs": runs,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if identical else 1


if __name__ == "__main__":
    sys.exit(main())
