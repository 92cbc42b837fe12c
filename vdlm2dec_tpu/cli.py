"""Command-line decoder: vdlm2dec-compatible flag surface + file input.

Mirrors the reference CLI (main.c:63-104,126-198) 1:1 where meaningful for an
offline accelerator decoder, and adds the capture-file input the reference lacks
(initFile/runFileSample are dead declarations, vdlm2.h:110-111):

  -v / -q            verbose / quiet
  -J                 JSON output
  -R                 flight-route/registration JSON (implies -J)
  -a                 registration CSV to stdout (disables JSON)
  -G -E -U           ground / empty / undecoded message passthrough
  -b lbl:lbl         ACARS label filter
  -i station_id      station id for JSON
  -j addr:port       UDP JSON feed
  -s addr:port       TCP SBS feed
  -l logfile         log file (append)
  frequencies (MHz)  positional, 118-138 MHz validated (rtl.c:222)

File/accelerator specific:
  --iq FILE          capture file (required)
  --format cu8|cs16|cf32|f32real
  --fs HZ            input sample rate (default 2,000,000)
  --fc HZ            center frequency (default: auto chooseFc)
  --block-seconds S  streaming block length
  --max-rows N       burst capacity cap (8 = full VDL-M2)
  --mesh CxT         device mesh, e.g. 1x4 (chan x time shards)
"""
from __future__ import annotations

import argparse
import sys
import numpy as np

from .constants import MAX_BURST_SYMBOLS
from .host.decoder import FrameDecoder
from .host.output import OutputConfig
from .io.sdr import (choose_fc, choose_fc_airspy, match_device,
                     nearest_gain, validate_freqs)
from .pipeline import Pipeline, PipelineConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vdlm2t",
        description="JAX VDL Mode 2 decoder (vdlm2dec-compatible)",
    )
    p.add_argument("freqs", nargs="+", type=float, help="frequencies in MHz")
    p.add_argument("--iq", required=True, help="IQ capture file")
    p.add_argument("--format", default="cu8",
                   choices=["cu8", "cs16", "cf32", "f32real"])
    p.add_argument("--fs", type=int, default=2_000_000)
    p.add_argument("--fc", type=float, default=None)
    p.add_argument("--block-seconds", type=float, default=4.0)
    p.add_argument("--max-rows", type=int, default=8)
    p.add_argument("--mesh", default=None, help="chan x time, e.g. 1x4")
    p.add_argument("--start-time", type=float, default=None,
                   help="capture start unix time (default: now)")
    p.add_argument("--stats", action="store_true",
                   help="print per-stage metrics JSON to stderr at end")
    p.add_argument("--stats-interval", type=float, default=0.0,
                   help="also print the metrics JSON to stderr every N "
                        "seconds while decoding (long/live jobs)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file: resume from it and update per block")
    p.add_argument("--channel-filter", default="boxcar",
                   choices=["boxcar", "fir"],
                   help="boxcar = reference-parity integrate-and-dump; "
                        "fir = windowed-sinc with >60 dB adjacent-channel "
                        "rejection")
    p.add_argument("--sync-impl", default="stream",
                   choices=["xla", "stream"],
                   help="stream (default): branch-0 filter + running-sum "
                        "sync + inline demod filtering; xla: full polyphase "
                        "filter tensor (frame-parity tested)")
    p.add_argument("--compute", default="f32", choices=["f32", "bf16"],
                   help="bf16: channelizer matmuls on bfloat16 operands with "
                        "f32 accumulation (header/RS/CRC stay exact; "
                        "frame-parity tested)")
    p.add_argument("--chan-impl", default="auto",
                   choices=["auto", "matmul", "dft", "pfb"],
                   help="auto (default) = residue-space dft when the plan "
                        "is eligible (raster offsets, boxcar — every real "
                        "VDL plan), else dense matmul; dft = residue-space "
                        "channelizer (25/84 the FLOPs, same products, "
                        "scales to whole-band channel counts); pfb = "
                        "factorized-DFT filterbank (O(sqrt(tbl)) per "
                        "output, for hundreds of channels)")

    p.add_argument("-v", dest="verbose", action="store_true")
    p.add_argument("-q", dest="quiet", action="store_true")
    p.add_argument("-J", dest="jsonout", action="store_true")
    p.add_argument("-R", dest="routeout", action="store_true")
    p.add_argument("-a", dest="regout", action="store_true")
    p.add_argument("-G", dest="grndmess", action="store_true")
    p.add_argument("-E", dest="emptymess", action="store_true")
    p.add_argument("-U", dest="undecmess", action="store_true")
    p.add_argument("-b", dest="labelfilter", default=None)
    # reference default station id = hostname (main.c:120-121)
    import socket as _socket

    p.add_argument("-i", dest="station", default=_socket.gethostname()[:48])
    p.add_argument("-p", dest="ppm", type=float, default=0.0,
                   help="frequency correction in ppm (rtl.c:211-216); "
                        "applied as an fc shift here, see PARITY.md")
    p.add_argument("-g", dest="gain", type=int, default=None,
                   help="rtl: preamp gain in tenths of dB, snapped to the "
                        "nearest supported value (rtl.c:162-184); airspy "
                        "(f32real): linearity gain 0-21 (air.c:159)")
    p.add_argument("-r", dest="rtldevice", default=None,
                   help="rtl device number or serial (verbose_device_search"
                        " semantics, rtl.c:47-121); takes effect with SDR "
                        "hardware, validated against --devices when given")
    p.add_argument("-k", dest="airspy_serial", default=None,
                   help="airspy serial number in hex (main.c:156-158)")
    p.add_argument("--devices", default=None,
                   help="comma-separated known device serials for -r "
                        "matching (stands in for the USB enumeration)")
    p.add_argument("-j", dest="netjson", default=None)
    p.add_argument("-s", dest="netsbs", default=None)
    p.add_argument("-l", dest="logfile", default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .compile_cache import enable_compile_cache

    enable_compile_cache()

    # drain-and-exit on SIGTERM/SIGQUIT like SIGINT (sighandler ->
    # stopVdlm2, main.c:106-110,215-220); in-flight host work is flushed
    # by the KeyboardInterrupt handlers below
    import signal as _signal
    import threading as _threading

    def _stop(signum, frame):
        raise KeyboardInterrupt

    if _threading.current_thread() is _threading.main_thread():
        for _sig in (_signal.SIGTERM, getattr(_signal, "SIGQUIT", None)):
            if _sig is not None:
                try:
                    _signal.signal(_sig, _stop)
                except (ValueError, OSError):
                    pass

    verbose = 1
    if args.verbose:
        verbose = 2
    if args.quiet:
        verbose = 0
    jsonout = args.jsonout
    routeout = args.routeout
    regout = args.regout
    if routeout:
        jsonout = True            # main.c:169-172
    if regout:
        jsonout = False           # main.c:173-176
    if jsonout or regout:
        verbose = 0               # main.c:200-201

    freqs = validate_freqs([int(f * 1e6) for f in args.freqs])
    if not freqs:
        print("Need at least one valid frequency (118-138 MHz)", file=sys.stderr)
        return 1
    if args.chan_impl in ("dft", "pfb") and args.channel_filter != "boxcar":
        print(f"--chan-impl {args.chan_impl} requires the boxcar channel filter",
              file=sys.stderr)
        return 1

    real_input = args.format == "f32real"
    try:
        if args.fc is not None:
            fc = args.fc
        elif real_input:
            fc = choose_fc_airspy(freqs, args.fs)
        else:
            fc = choose_fc(freqs, args.fs)
    except ValueError as e:
        # reference prints the message and exits (rtl.c:142, air.c:166)
        print(str(e), file=sys.stderr)
        return 1
    if args.ppm:
        # a tuner ppm error shifts every RF frequency (and the sample clock;
        # the demod's per-burst CFO estimator absorbs the residual) — apply
        # the dominant effect: shift the effective center frequency
        fc = fc * (1.0 + args.ppm / 1e6)

    # SDR device/gain flags: pure selection logic runs here (differential-
    # tested in io/sdr.py); the USB register writes need real hardware.
    if args.gain is not None:
        from .io.sdr import R820T_GAINS

        if real_input:
            if not 0 <= args.gain <= 21:
                print("airspy linearity gain must be 0-21", file=sys.stderr)
                return 1
            gain = args.gain                      # air.c:159
        else:
            gain = nearest_gain(args.gain, R820T_GAINS)  # rtl.c:162-184
        if args.verbose:
            # rtl.c:181-183 prints the snapped gain at verbose
            print(f"Gain set to {gain / 10:.1f}" if not real_input
                  else f"Linearity gain {gain}", file=sys.stderr)
    if args.rtldevice is not None and args.devices is not None:
        idx = match_device(args.rtldevice, args.devices.split(","))
        if idx < 0:
            # verbose_device_search failure exits (rtl.c:118-120)
            print(f"No matching device found for {args.rtldevice}",
                  file=sys.stderr)
            return 1
        if args.verbose:
            print(f"Using device {idx}", file=sys.stderr)
    if args.airspy_serial is not None:
        try:
            int(args.airspy_serial, 16)           # strtoull(,,16)
        except ValueError:
            print(f"invalid airspy serial {args.airspy_serial}",
                  file=sys.stderr)
            return 1

    logfd = open(args.logfile, "a") if args.logfile else None

    mesh = None
    if args.mesh:
        import jax

        from .parallel.sharding import make_mesh

        c, t = args.mesh.lower().split("x")
        mesh = make_mesh(int(c), int(t), devices=jax.devices())

    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs],
        fs=args.fs,
        fc_hz=float(fc),
        real_input=real_input,
        max_symbols=min(MAX_BURST_SYMBOLS, args.max_rows * 680 + 16),
        mesh=mesh,
        filter_mode=args.channel_filter,
        chan_impl=args.chan_impl,
        compute=args.compute,
        sync_impl=args.sync_impl,
    )
    pipe = Pipeline(cfg)

    out_cfg = OutputConfig(
        verbose=verbose,
        jsonout=jsonout,
        routeout=routeout,
        regout=regout,
        grndmess=args.grndmess,
        emptymess=args.emptymess,
        undecmess=args.undecmess,
        station_id=args.station,
        net_json_addr=args.netjson,
        net_sbs_addr=args.netsbs,
        logfile=logfd,
    )
    dec = FrameDecoder(out_cfg, label_filter=args.labelfilter,
                       time_base=args.start_time)

    from .metrics import PipelineMetrics

    metrics = PipelineMetrics()
    pipe.metrics = metrics
    cursor = 0
    prev_end: dict[int, int] = {}
    if args.checkpoint:
        import os

        from .host.checkpoint import load_checkpoint, save_checkpoint

        if os.path.exists(args.checkpoint):
            cursor, extra = load_checkpoint(args.checkpoint, dec.flights)
            prev_end = {int(k): int(v)
                        for k, v in extra.get("prev_end", {}).items()}

    import time as _time

    last_stats = _time.monotonic()

    def periodic_stats():
        nonlocal last_stats
        if (args.stats_interval
                and _time.monotonic() - last_stats >= args.stats_interval):
            last_stats = _time.monotonic()
            print(metrics.report(), file=sys.stderr)

    if args.iq == "-":
        # live pipe: rtl_sdr/airspy_rx | vdlm2t ... --iq -
        n_frames = 0
        try:
            for bursts in pipe.stream_live(
                "-", fmt=args.format, block_seconds=args.block_seconds
            ):
                metrics.observe_bursts(bursts)
                for b in bursts:
                    dec.process_burst(b)
                    n_frames += len(b.frames)
                periodic_stats()
        except KeyboardInterrupt:
            # drain-and-exit semantics (sighandler -> stopVdlm2,
            # main.c:106-110): in-flight host work is already flushed
            pass
        if args.stats:
            print(metrics.report(), file=sys.stderr)
        if verbose:
            print(f"\n# {n_frames} frames decoded", file=sys.stderr)
        if logfd:
            logfd.close()
        return 0

    from .io.sdr import CaptureReader

    try:
        reader = CaptureReader(args.iq, args.format)
    except (OSError, ValueError) as e:
        print(f"unable to open {args.iq}: {e}", file=sys.stderr)
        return 1
    total_samples = len(reader)
    metrics.samples_in = total_samples
    n_frames = 0
    # exact resume: blocks are addressed by absolute position, so decoding
    # from start_block yields byte-identical output to the uninterrupted
    # run's remaining blocks (the checkpoint cursor is block-aligned and
    # prev_end restores cross-block burst-span suppression)
    core_raw = pipe.core_raw_samples(args.block_seconds)
    start_block = min(cursor, total_samples) // core_raw
    # the fused program is boxcar-only
    fused_ok = (cfg.lo_wrap and mesh is None
                and cfg.filter_mode == "boxcar")
    if fused_ok:
        # fast path: native-format raw blocks through the fused pipelined
        # device program (convert on device, one dispatch+fetch per block)
        raw = reader.raw
        stream = pipe.stream_wideband_u8(
            raw, block_seconds=args.block_seconds,
            start_block=start_block, prev_end=prev_end, fmt=args.format,
        )
    else:
        stream = pipe.stream_wideband(
            reader, block_seconds=args.block_seconds,
            start_block=start_block, prev_end=prev_end,
        )
    try:
        for k, bursts in enumerate(stream):
            metrics.observe_bursts(bursts)
            for b in bursts:
                dec.process_burst(b)
                n_frames += len(b.frames)
            if args.checkpoint:
                cursor = min((start_block + k + 1) * core_raw, total_samples)
                save_checkpoint(args.checkpoint, cursor, dec.flights,
                                extra={"prev_end": prev_end})
            periodic_stats()
    except KeyboardInterrupt:
        pass
    metrics.frames_emitted = dec.stats.acars + dec.stats.xid
    if args.stats:
        print(metrics.report(), file=sys.stderr)
    if verbose:
        print(f"\n# {n_frames} frames decoded", file=sys.stderr)
    if logfd:
        logfd.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
