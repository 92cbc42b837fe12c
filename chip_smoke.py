#!/usr/bin/env python3
"""Smoke test of the VDL2 decode path on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
full width of each deployment, and checks what comes out:

  station  RTL station (vdlm2.h:26, rtl.c:36): 8 channels, a 12 s cu8
           capture at 2 Msps through the CLI (vdlm2dec_tpu.cli.main,
           default flags, -J).  Every synthesized burst decoded, no
           spurious frame, output identical to the CPU backend's.
  band     whole VDL band: 760 channels at 25 kHz (118.5-137.5 MHz) from
           a 20 Msps cu8 capture through Pipeline.stream_wideband_u8 with
           the pfb channelizer.  Full recall, no spurious frame.
  options  every user option (channelizer, channel filter, sync, compute,
           input format incl. Airspy f32real at 6 Msps) gives the frames
           the default gives.
  stages   channelizer, sync metric, header trellis and RS rows on the
           card against the plain reference (golden/) and the CPU backend.
  --four   only the sharded path: the band through a 2x2 (chan, time)
           mesh on four cards against a one-card run.

Each phase prints one line.  The card's nvidia-smi name and power limit
precede the last line, which is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
The script exits non-zero on the first failure and when JAX finds no GPU;
it never falls back to the CPU.

Usage:  python chip_smoke.py [--four]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

STATION_FS = 2_000_000
BAND = dict(fs=20_000_000, n_channels=760, seconds=1.0, spacing=25_000,
            active_every=48, base=118_500_000)


class SmokeFailure(RuntimeError):
    pass


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _peak_gib(device) -> float | None:
    stats = device.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return None
    return round(stats["peak_bytes_in_use"] / 2**30, 3)


def _recall(got: list, want: list) -> dict:
    """Per-burst recall of decoded keys against the synthesized truth."""
    g, w = Counter(got), Counter(want)
    matched = sum(min(g[k], n) for k, n in w.items())
    return {"bursts": len(want), "matched": matched,
            "missed": len(want) - matched,
            "spurious": sum(n for k, n in g.items() if k not in w),
            "duplicates": sum(max(g[k] - w[k], 0) for k in g if k in w)}


def _require_full_recall(rec: dict, what: str) -> None:
    _check(rec["bursts"] > 0 and rec["missed"] == 0
           and rec["spurious"] == 0 and rec["duplicates"] == 0,
           f"{what}: recall {rec}")


# -- the CLI, in-process -------------------------------------------------

def _cli_keys(lines: list[str]) -> list:
    """(freq kHz, frame bytes after the AVLC header) of every JSON line.
    -G -E -U pass every CRC-valid frame through; frames whose payload is
    not ACARS/XID carry it as the hex "data" field."""
    keys = []
    for line in lines:
        j = json.loads(line)
        keys.append((int(round(j["freq"] * 1000)), j.get("data")))
    return keys


def _truth_keys(truth, freqs) -> list:
    return [(freqs[ch] // 1000, content[9:].hex())
            for ch, content, *_ in truth]


def _run_cli(argv: list[str], workdir: str) -> tuple[list[str], float]:
    from vdlm2dec_tpu.cli import main

    log = os.path.join(workdir, "cli_out.json")
    if os.path.exists(log):
        os.remove(log)
    t0 = time.perf_counter()
    rc = main(argv + ["-J", "-G", "-E", "-U", "-i", "SMOKE",
                      "--start-time", "0", "-l", log])
    dt = time.perf_counter() - t0
    _check(rc == 0, f"CLI exited {rc}: {argv}")
    with open(log) as fh:
        return [ln for ln in fh.read().splitlines() if ln.strip()], dt


def _station_args(path: str, freqs, fc, max_rows: int) -> list[str]:
    return [*(f"{f / 1e6:.6f}" for f in freqs), "--iq", path,
            "--fc", str(fc), "--max-rows", str(max_rows)]


def phase_station(workdir: str, seconds: float = 12.0, max_rows: int = 8,
                  block_seconds: float = 4.0,
                  compare_cpu: bool = True) -> dict:
    """8-channel RTL station through the CLI (4 s blocks, -J)."""
    import jax

    import bench

    # at most ~28 bursts per channel in a 4 s block: the CLI's default
    # capacity is 32 sync candidates per channel and block
    wide, freqs, fc, truth = bench.make_capture(STATION_FS, 8, seconds,
                                                seed=1, gap=(6500, 16000))
    path = os.path.join(workdir, "station.cu8")
    bench.to_u8(wide).tofile(path)
    argv = _station_args(path, freqs, fc, max_rows) + [
        "--block-seconds", str(block_seconds)]
    lines_cold, t_cold = _run_cli(argv, workdir)
    lines, t_warm = _run_cli(argv, workdir)
    _check(lines == lines_cold, "station: warm and cold runs differ")
    rec = _recall(_cli_keys(lines), _truth_keys(truth, freqs))
    _require_full_recall(rec, "station")
    out = {"recall": f"{rec['matched']}/{rec['bursts']}",
           "spurious": rec["spurious"],
           "compile_s": round(t_cold - t_warm, 3),
           "cli_warm_s": round(t_warm, 3),
           "cli_warm_msps": round(len(wide) / t_warm / 1e6, 3),
           "peak_gib": _peak_gib(jax.devices()[0])}
    if compare_cpu:
        with jax.default_device(jax.devices("cpu")[0]):
            lines_cpu, _ = _run_cli(argv, workdir)
        _check(lines_cpu == lines,
               f"station: GPU and CPU output differ "
               f"({len(lines)} vs {len(lines_cpu)} lines)")
        out["identical_to_cpu"] = True
    return out


# -- the whole band through the Pipeline -----------------------------------

def _burst_keys(bursts) -> list:
    return [(b.channel, bytes(bytearray(f[1:-3])))
            for b in bursts for f in b.frames]


def _band_capture(plan: dict):
    import bench

    return bench.make_capture(
        plan["fs"], plan["n_channels"], plan["seconds"],
        spacing=plan["spacing"], active_every=plan["active_every"],
        base=plan["base"])


def _band_config(plan: dict, freqs, fc):
    from vdlm2dec_tpu.pipeline import PipelineConfig

    return PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=plan["fs"],
        fc_hz=float(fc), chan_impl="pfb", max_candidates=16,
        max_symbols=512,
        max_out=max(64, int(22 * plan["seconds"] * plan["n_channels"]
                            // plan["active_every"])))


def phase_band(workdir: str, plan: dict = BAND,
               block_seconds: float = 0.5) -> dict:
    """760-channel band, 20 Msps cu8, pfb channelizer, 0.5 s blocks."""
    import jax

    import bench
    from vdlm2dec_tpu.pipeline import Pipeline

    wide, freqs, fc, truth = _band_capture(plan)
    raw = bench.to_u8(wide)
    pipe = Pipeline(_band_config(plan, freqs, fc))

    def run():
        t0 = time.perf_counter()
        keys = _burst_keys(b for bs in pipe.stream_wideband_u8(
            raw, block_seconds=block_seconds) for b in bs)
        return keys, time.perf_counter() - t0

    keys_cold, t_cold = run()
    keys, t_warm = run()
    _check(keys == keys_cold, "band: warm and cold runs differ")
    rec = _recall(keys, [(c, content) for c, content, *_ in truth])
    _require_full_recall(rec, "band")
    return {"channels": plan["n_channels"],
            "recall": f"{rec['matched']}/{rec['bursts']}",
            "spurious": rec["spurious"],
            "compile_s": round(t_cold - t_warm, 3),
            "warm_s": round(t_warm, 3),
            "msps": round(len(wide) / t_warm / 1e6, 3),
            "peak_gib": _peak_gib(jax.devices()[0])}


# -- every user option ------------------------------------------------------

def _airspy_capture(wide: np.ndarray, shift_hz: float, fs_out: int):
    """Real Airspy-style capture at fs_out carrying the same channels as
    the complex capture `wide` (rate STATION_FS): band-limited resample,
    then 2*Re{z e^{j 2 pi shift t}}, which puts a channel at offset fo
    from the complex capture's centre at fo + shift (air.c:182-185)."""
    n = len(wide)
    m = n * fs_out // STATION_FS
    spec = np.fft.fft(wide.astype(np.complex128))
    up = np.zeros(m, dtype=np.complex128)
    h = n // 2
    up[:h] = spec[:h]
    up[m - (n - h):] = spec[h:]
    z = np.fft.ifft(up) * (m / n)
    t = np.arange(m)
    return (2.0 * np.real(z * np.exp(2j * np.pi * shift_hz / fs_out * t))
            ).astype(np.float32)


def phase_options(workdir: str, seconds: float = 2.0,
                  max_rows: int = 2) -> dict:
    """A 2 s station capture through the CLI under every user option."""
    import bench
    from vdlm2dec_tpu.io.sdr import write_capture

    wide, freqs, fc, truth = bench.make_capture(STATION_FS, 8, seconds,
                                                seed=2)
    paths = {fmt: os.path.join(workdir, f"opts.{fmt}")
             for fmt in ("cu8", "cs16", "cf32", "f32real")}
    bench.to_u8(wide).tofile(paths["cu8"])
    write_capture(paths["cs16"], wide * 256.0, "cs16")
    write_capture(paths["cf32"], wide, "cf32")
    air_fs, shift = 6_000_000, 1_000_000
    _airspy_capture(wide, shift, air_fs).tofile(paths["f32real"])
    # channel at f - fc + shift relative to F0 = fc_air + fs/4
    fc_air = fc - shift - air_fs // 4

    base = _station_args(paths["cu8"], freqs, fc, max_rows)
    cases = {
        "default": base,
        "chan-impl matmul": base + ["--chan-impl", "matmul"],
        "chan-impl dft": base + ["--chan-impl", "dft"],
        "chan-impl pfb": base + ["--chan-impl", "pfb"],
        "channel-filter fir": base + ["--channel-filter", "fir"],
        "sync-impl xla": base + ["--sync-impl", "xla"],
        "compute bf16": base + ["--compute", "bf16"],
        "format cs16": _station_args(paths["cs16"], freqs, fc, max_rows)
        + ["--format", "cs16"],
        "format cf32": _station_args(paths["cf32"], freqs, fc, max_rows)
        + ["--format", "cf32"],
        "format f32real 6 Msps": _station_args(
            paths["f32real"], freqs, fc_air, max_rows)
        + ["--format", "f32real", "--fs", str(air_fs)],
    }
    want = sorted(_truth_keys(truth, freqs))
    out = {}
    ref = None
    for name, argv in cases.items():
        lines, dt = _run_cli(argv, workdir)
        keys = sorted(_cli_keys(lines))
        if ref is None:
            _require_full_recall(_recall(keys, want), "options default")
            ref = keys
        _check(keys == ref, f"options: {name} gives other frames than the "
                            f"default ({len(keys)} vs {len(ref)})")
        out[name] = round(dt, 3)
    return {"frames": len(ref), "all_equal_default": True, "wall_s": out}


# -- stages against the plain reference --------------------------------------

def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.complex128)
                               - np.asarray(b, np.complex128))))


def _on_cpu(fn, *args):
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return fn(*[jax.device_put(np.asarray(a), cpu) for a in args])


def phase_stages(workdir: str, n_channels: int = 8) -> dict:
    """Device stages at station width against golden/ and the CPU."""
    del workdir
    import jax
    import jax.numpy as jnp

    from vdlm2dec_tpu import constants as C
    from vdlm2dec_tpu import modulator as mod
    from vdlm2dec_tpu.golden import codec
    from vdlm2dec_tpu.golden.dsp import GoldenChannel, mix_and_decimate
    from vdlm2dec_tpu.ops import header, rs_fec
    from vdlm2dec_tpu.ops.channelizer import Channelizer, period_for
    from vdlm2dec_tpu.ops.demod import (pack_complex, phase_of,
                                        polyphase_filter0, sync_scan)

    rng = np.random.default_rng(3)
    out = {}

    # channelizer vs the reference mixer + integrate-and-dump; the device
    # runs f32 at HIGHEST precision, the reference float64
    tol = 5e-4
    offsets = [-175_000.0 + 50_000.0 * i for i in range(n_channels)]
    p_in, _ = period_for(STATION_FS // 4000)
    n = 20 * p_in
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    ref = np.stack([mix_and_decimate(x, fo, STATION_FS, STATION_FS // 4000)
                    for fo in offsets])
    for impl in ("matmul", "dft", "pfb"):
        y = np.asarray(Channelizer(offsets, fs=STATION_FS, impl=impl)(x))
        err = _max_err(y[..., 0] + 1j * y[..., 1], ref)
        out[f"channelizer_{impl}"] = {"max_abs_err": err, "atol": tol}
        _check(err <= tol, f"channelizer {impl}: {err} > {tol}")

    # sync metric: one impaired burst per channel.  Against golden (float64
    # serial decoder, positions before its first trigger) at the tolerance
    # the CPU tests hold; against the CPU backend over the whole stream at
    # the tolerance of the two atan2 implementations' last-bit drift
    sigs, goldens = [], []
    for ci in range(n_channels):
        content = rng.integers(0, 256, 30).astype(np.uint8)
        sig = mod.synthesize_baseband(
            mod.make_burst([content]), start=400 + 37 * ci,
            cfo_hz=float(rng.uniform(-300, 300)))
        sigs.append(mod.awgn(sig, 18.0, rng))
    t_len = min(len(s) for s in sigs)
    sigs = np.stack([s[:t_len] for s in sigs])
    for s in sigs:
        g = GoldenChannel()
        g.run(s)
        goldens.append(g)

    def metric(y):
        return sync_scan(phase_of(polyphase_filter0(y)))

    y = pack_complex(sigs)
    err, fr = (np.asarray(v) for v in jax.jit(metric)(jnp.asarray(y)))
    gerr = gfr = 0.0
    checked = 0
    for ci, g in enumerate(goldens):
        first = g.bursts[0].start_index if g.bursts else t_len
        for t, ge, gf in g.sync_errs:
            if 200 <= t < first:
                gerr = max(gerr, abs(float(err[ci, t]) - ge))
                gfr = max(gfr, abs(float(fr[ci, t]) - gf))
                checked += 1
    out["sync_vs_golden"] = {"positions": checked,
                             "err_max_abs": gerr, "err_atol": 2e-3,
                             "fr_max_abs": gfr, "fr_atol": 1e-4}
    _check(checked > 50 and gerr <= 2e-3 and gfr <= 1e-4,
           f"sync vs golden: {out['sync_vs_golden']}")
    err_c, fr_c = (np.asarray(v) for v in _on_cpu(jax.jit(metric), y))
    for name, a, b, atol in (("err", err, err_c, 1e-4),
                             ("fr", fr, fr_c, 1e-5)):
        worst = float(np.max(np.abs(a - b) - 1e-4 * np.abs(b)))
        out[f"sync_{name}_vs_cpu"] = {
            "max_abs": _max_err(a, b), "rtol": 1e-4, "atol": atol,
            "worst_excess_over_rtol": worst}
        _check(worst <= atol, f"sync {name} vs CPU: {worst} > {atol}")

    # header trellis on the same soft input: bit-exact with the CPU and
    # with the golden decoder
    softs, want = [], []
    for _ in range(256):
        length = int(rng.integers(96, 8 * 1992))
        bits = codec.header_encode(length)
        soft = np.clip(bits * 0.96 + 0.02 + rng.normal(0, 0.05, 25),
                       0.001, 0.999).astype(np.float32)
        softs.append(soft)
        want.append(codec.header_decode_soft(soft.astype(np.float64))[0])
    softs = np.stack(softs)
    got = [np.asarray(v) for v in header.header_decode(jnp.asarray(softs))]
    got_c = [np.asarray(v) for v in _on_cpu(header.header_decode, softs)]
    _check(all(np.array_equal(a, b) for a, b in zip(got, got_c)),
           "header: GPU and CPU differ")
    _check(np.array_equal(got[0], want), "header: GPU differs from golden")
    out["header"] = {"rows": len(want), "bit_exact": True}

    # RS rows with errors and erasures: bit-exact with golden and the CPU
    rows, classes, want_rows, want_counts = [], [], [], []
    for _ in range(512):
        data = rng.integers(0, 256, C.RS_K).astype(np.uint8)
        bad = np.concatenate([data, codec.rs_encode_row(data)])
        for p in rng.choice(C.RS_N, int(rng.integers(0, 6)), replace=False):
            bad[p] ^= int(rng.integers(1, 256))
        cls = int(rng.integers(0, 3))
        for e in [[], [253, 254], [251, 252, 253, 254]][cls]:
            bad[e] = 0
        g_out, g_cnt = codec.rs_decode_row(
            bad.copy(), [[], [253, 254], [251, 252, 253, 254]][cls])
        rows.append(bad)
        classes.append(cls)
        want_rows.append(g_out)
        want_counts.append(g_cnt)
    rows, classes = np.stack(rows), np.asarray(classes, np.int32)
    fixed, counts = (np.asarray(v) for v in rs_fec.rs_decode_rows(
        jnp.asarray(rows), jnp.asarray(classes)))
    fixed_c, counts_c = (np.asarray(v) for v in _on_cpu(
        rs_fec.rs_decode_rows, rows, classes))
    _check(np.array_equal(fixed, fixed_c) and np.array_equal(counts, counts_c),
           "RS: GPU and CPU differ")
    _check(np.array_equal(fixed, np.stack(want_rows))
           and np.array_equal(counts, want_counts), "RS: GPU differs from golden")
    out["rs"] = {"rows": len(rows), "bit_exact": True,
                 "uncorrectable": int(np.sum(counts < 0))}
    return out


# -- four cards ---------------------------------------------------------------

def phase_sharded(workdir: str, plan: dict = BAND, mesh_shape=(2, 2)) -> dict:
    """The band through a (chan, time) mesh against a one-card run."""
    del workdir
    import jax

    from vdlm2dec_tpu.parallel.sharding import make_mesh
    from vdlm2dec_tpu.pipeline import Pipeline

    wide, freqs, fc, truth = _band_capture(plan)
    cfg = _band_config(plan, freqs, fc)
    t0 = time.perf_counter()
    one = _burst_keys(Pipeline(cfg).decode_wideband(wide))
    t_one = time.perf_counter() - t0
    mesh = make_mesh(*mesh_shape, devices=jax.devices())
    t0 = time.perf_counter()
    sharded = _burst_keys(Pipeline(dataclasses.replace(cfg, mesh=mesh))
                          .decode_wideband(wide))
    t_sharded = time.perf_counter() - t0
    rec = _recall(sharded, [(c, content) for c, content, *_ in truth])
    _check(sorted(sharded) == sorted(one),
           f"sharded frames differ from the one-card run "
           f"({len(sharded)} vs {len(one)})")
    _require_full_recall(rec, "sharded")
    return {"mesh": "x".join(map(str, mesh_shape)),
            "channels": plan["n_channels"],
            "recall": f"{rec['matched']}/{rec['bursts']}",
            "equal_to_one_card": True,
            "one_card_s_incl_compile": round(t_one, 3),
            "sharded_s_incl_compile": round(t_sharded, 3)}


# -- entry point -------------------------------------------------------------

def card_info() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded 2x2 mesh path on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 1

    from vdlm2dec_tpu.compile_cache import enable_compile_cache

    print(f"device: {devices[0].device_kind} x{len(devices)}", flush=True)
    print(f"nvidia-smi: {card_info()}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    phases = ([phase_sharded] if args.four else
              [phase_station, phase_band, phase_options, phase_stages])
    with tempfile.TemporaryDirectory() as workdir:
        for phase in phases:
            t0 = time.perf_counter()
            res = phase(workdir)
            res["phase_s"] = round(time.perf_counter() - t0, 3)
            print(f"{phase.__name__}: {json.dumps(res)}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
