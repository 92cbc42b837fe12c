"""Multi-host decode: jax.distributed + a global (chan, time) mesh across hosts.

The reference is single-host by construction (pthread barriers,
vdlm2.h:85); this module is the framework's scale-out axis and makes the
SCALING.md cost model executable:

  * channels shard over each host's local devices ("chan" rides NVLink);
  * time blocks shard ACROSS hosts ("time" rides the host network) — the only
    cross-host traffic is the 84 kHz halo exchange at each seam
    (HALO_LEFT + one burst window) plus the packed candidate rows;
  * every host keeps only its own time slice of the input (channelized
    locally, period-aligned) and emits frames for triggers inside its
    own shards — per-host output streams, no global gather.

Worker entry (one process per host):

    python -m vdlm2dec_tpu.parallel.multihost \
        --coordinator host0:9911 --num-processes 2 --process-id $I \
        --iq capture.cu8 --fc 136900000 136.975 136.875 ...

launch_local(n) spawns N such workers on this machine (4 virtual CPU
devices each) for testing without a cluster; tests/test_multihost.py
proves a burst whose halo crosses the process boundary decodes
bit-identically to a single-process run of the same mesh.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """jax.distributed bring-up (idempotent)."""
    import jax

    if num_processes > 1 or coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )


def global_mesh(n_chan: int, n_time: int):
    """(chan, time) mesh over ALL processes' devices, laid out so the chan
    axis stays within a host (NVLink) and the time axis advances across
    hosts (host network): jax.devices() orders by process id, so time-major
    re-gridding puts each host's devices in consecutive time columns."""
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices())
    assert devs.size >= n_chan * n_time, (
        f"need {n_chan * n_time} devices, have {devs.size}"
    )
    grid = devs[: n_chan * n_time].reshape(n_time, n_chan).T
    return Mesh(grid, axis_names=("chan", "time"))


class MultiHostDecoder:
    """Packed sharded decode where the time axis spans processes.

    decode_local(y_local): y_local is THIS process's (C, T_local, 2)
    decimated slice (T_local = T_global / n_processes, divisible by the
    per-host time-shard count).  Returns the candidate dicts whose
    triggers live in this host's shards, with global chan/t0.
    """

    def __init__(self, mesh, max_candidates: int = 8,
                 max_symbols: int = 1024, max_out: int = 64,
                 raw_f_offsets=None, fs: int = 2_000_000,
                 sdrclk: int | None = None, lo_wrap: bool = True):
        import jax
        from jax.sharding import PartitionSpec as P

        from .sharding import packed_decode_step

        self.mesh = mesh
        self._spec = P("chan", "time", None)
        self._tok_spec = P(("chan", "time"))
        base_step = packed_decode_step(max_candidates, max_symbols, max_out)

        def chained(y, tok):
            # Token chaining: tok is the previous window's token OUTPUT, so
            # this program's inputs are not ready — and the program cannot
            # START — until the previous collective program has finished.
            # Without it, dispatch_depth >= 2 keeps two programs with Gloo
            # collectives in flight per process, and XLA-CPU gives no
            # cross-PROGRAM ordering guarantee: process A can enter window
            # w+1's rendezvous while B is still in w's, and both block
            # forever (observed as a rare futex deadlock in the scaling
            # sweep; a GPU runs one process's programs in stream order, so
            # this is hardening for the CPU emulation path).  tok is always 0.0; the add is an
            # exact f32 identity and the min keeps the output token
            # data-DEPENDENT on the decode so XLA cannot constant-fold the
            # chain away.
            import jax.numpy as jnp

            y = y + tok[0]
            buf = base_step(y)
            tok_out = jnp.minimum(
                buf.ravel()[0].astype(jnp.float32), jnp.float32(0.0)
            )[None]
            return buf, tok_out

        self._step = jax.jit(
            jax.shard_map(
                chained,
                mesh=mesh,
                in_specs=(self._spec, self._tok_spec),
                out_specs=(P(("chan", "time"), None), self._tok_spec),
            )
        )
        self._tok = None

        # raw-ingest path: channelize INSIDE the sharded program from each
        # host's raw period-aligned slice — the worker's old flow
        # channelized on device, fetched the decimated block to host and
        # re-uploaded it into the collective, a pure per-window round
        # trip on the critical path
        self._raw_step = None
        if raw_f_offsets is not None:
            import jax.numpy as jnp
            from jax.experimental import multihost_utils

            from ..ops.channelizer import (
                aggregation_matrix,
                lo_tables,
                period_for,
            )
            from .sharding import raw_decode_step

            sdrclk = sdrclk if sdrclk is not None else fs // 4000
            self.p_in, self.p_out = period_for(sdrclk)
            fo = tuple(float(f) for f in raw_f_offsets)
            lo, _ = lo_tables(fo, fs, sdrclk, lo_wrap)
            ang = (np.zeros(len(fo))
                   if lo_wrap
                   else 2.0 * np.pi * np.asarray(fo) * (self.p_in / fs))
            raw_body = raw_decode_step(max_candidates, max_symbols,
                                       max_out, self.p_in)

            def chained_raw(x, lo_r, lo_i, a, ang, period0, tok):
                # same token chain as `chained` (see above)
                x = x + tok[0]
                buf = raw_body(x, lo_r, lo_i, a, ang, period0[0])
                tok_out = jnp.minimum(
                    buf.ravel()[0].astype(jnp.float32), jnp.float32(0.0)
                )[None]
                return buf, tok_out

            self._raw_in_spec = P("time", None)
            self._raw_step = jax.jit(
                jax.shard_map(
                    chained_raw,
                    mesh=mesh,
                    in_specs=(self._raw_in_spec, P("chan", None),
                              P("chan", None), P(None, None), P("chan"),
                              P(), self._tok_spec),
                    out_specs=(P(("chan", "time"), None), self._tok_spec),
                )
            )
            # constants become committed global arrays ONCE (re-passing
            # host numpy every window would re-upload them each dispatch)
            g = lambda arr, spec: (  # noqa: E731
                multihost_utils.host_local_array_to_global_array(
                    np.ascontiguousarray(arr), mesh, spec))
            self._raw_consts = (
                g(lo.real.astype(np.float32), P("chan", None)),
                g(lo.imag.astype(np.float32), P("chan", None)),
                g(aggregation_matrix(sdrclk), P(None, None)),
                g(ang.astype(np.float32), P("chan")),
            )

    def _initial_token(self):
        import numpy as _np
        from jax.experimental import multihost_utils

        n_local = sum(1 for _ in self.mesh.local_mesh.devices.flat)
        return multihost_utils.host_local_array_to_global_array(
            _np.zeros(n_local, _np.float32), self.mesh, self._tok_spec
        )

    def dispatch(self, y_local: np.ndarray):
        """Enqueue the collective decode of this process's slice and return
        the (async) global result array WITHOUT materializing it.  JAX
        dispatch is asynchronous, so the cross-host rendezvous and the
        shard compute proceed in the runtime while the caller channelizes
        the next window — the double-buffering that hides per-window
        collective latency (SCALING.md).  Consecutive dispatches are
        token-chained so each process's collective programs execute in
        dispatch order (see `chained` above).

        NOT thread-safe: the token is read-modify-write state, so all
        dispatch() calls must come from one thread (the worker's main
        loop does; a concurrent-dispatch pattern would race the token
        and void the program-ordering guarantee it exists to provide)."""
        from jax.experimental import multihost_utils

        from ..ops.demod import pack_complex

        if np.iscomplexobj(y_local):
            y_local = pack_complex(y_local)
        g = multihost_utils.host_local_array_to_global_array(
            np.asarray(y_local, dtype=np.float32), self.mesh, self._spec
        )
        if self._tok is None:
            self._tok = self._initial_token()
        out, self._tok = self._step(g, self._tok)
        return out

    def dispatch_raw(self, x_local: np.ndarray, period0: int):
        """dispatch() for the raw-ingest path (requires raw_f_offsets at
        construction): x_local is THIS process's raw (T_raw_local, 2)
        f32 plane slice, period-aligned; period0 is the GLOBAL
        channelizer-period index of the dispatched span's first sample.
        Channelize runs inside the collective program — no decimated
        round-trip.  Same single-thread contract as dispatch()."""
        from jax.experimental import multihost_utils
        from jax.sharding import PartitionSpec as P

        assert self._raw_step is not None, (
            "MultiHostDecoder was built without raw_f_offsets"
        )
        g = multihost_utils.host_local_array_to_global_array(
            np.asarray(x_local, dtype=np.float32), self.mesh,
            self._raw_in_spec
        )
        p0 = multihost_utils.host_local_array_to_global_array(
            np.asarray([period0], np.float32), self.mesh, P(None)
        )
        if self._tok is None:
            self._tok = self._initial_token()
        lo_r, lo_i, a, ang = self._raw_consts
        out, self._tok = self._raw_step(g, lo_r, lo_i, a, ang, p0,
                                        self._tok)
        return out

    def fetch(self, out) -> list[dict]:
        """Materialize a dispatch() result: block on this host's shards and
        unpack the candidate rows whose triggers live in them."""
        from ..pipeline import unpack_results

        rows = [np.asarray(s.data) for s in out.addressable_shards]
        if not rows:
            return []
        return unpack_results(np.concatenate(rows, axis=0))

    def decode_local(self, y_local: np.ndarray) -> list[dict]:
        return self.fetch(self.dispatch(y_local))


# -- worker --------------------------------------------------------------------
def _worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vdlm2t-multihost",
        description="one per-host worker of a multi-host decode job",
    )
    ap.add_argument("freqs", nargs="*", type=float, help="frequencies in MHz")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--chan-shards", type=int, default=1)
    ap.add_argument("--time-shards", type=int, default=0,
                    help="global time shards (default: all devices / chan)")
    ap.add_argument("--iq", default=None, help="capture path (shared fs)")
    ap.add_argument("--format", default="cu8",
                    choices=("cu8", "cs16", "cf32", "f32real"),
                    help="capture sample format (f32real = airspy-style "
                         "real capture; channels sit at fc + fs/4)")
    ap.add_argument("--chan-impl", default="matmul",
                    choices=("matmul", "dft", "pfb"),
                    help="channelizer implementation (dft/pfb: residue-"
                         "space variants for high channel counts)")
    ap.add_argument("--y-npy", default=None,
                    help="decimated (C, T) complex .npy (test input)")
    ap.add_argument("--fs", type=int, default=2_000_000)
    ap.add_argument("--fc", type=float, default=None)
    ap.add_argument("--max-candidates", type=int, default=8)
    ap.add_argument("--max-symbols", type=int, default=256)
    ap.add_argument("--max-out", type=int, default=64)
    ap.add_argument("--block-seconds", type=float, default=0.0,
                    help="stream the capture in windows of this length "
                         "(constant memory per host; 0 = one-shot)")
    ap.add_argument("--timing", action="store_true",
                    help="windowed mode: print a STATS json line with the "
                         "post-warmup wall time and global samples covered "
                         "(window 0 = compile+warmup, excluded)")
    ap.add_argument("--checkpoint", default=None,
                    help="windowed mode: per-host resume state (cursor, "
                         "burst-span suppression, flight tracker) is kept "
                         "in <path>.p<process_id>; on restart every host "
                         "resumes at the earliest unfinished window across "
                         "hosts (the collective sequence must realign) and "
                         "skips re-emitting windows it already emitted.  "
                         "Exactly-once output under a clean stop; a hard "
                         "kill between emit and checkpoint re-emits at "
                         "most one window on restart")
    ap.add_argument("--abort-after-window", type=int, default=-1,
                    help="test hook: exit cleanly right after this "
                         "window's result is emitted and checkpointed")
    ap.add_argument("--dispatch-depth", type=int, default=2,
                    help="windowed mode: how many windows may be "
                         "dispatched (channelized + enqueued into the "
                         "collective) before the oldest is fetched.  "
                         "Depth 1 is fetch-before-next-dispatch; depth 2 "
                         "(default) hides one window's collective "
                         "rendezvous + emit/IO skew behind the next "
                         "window's channelize; deeper absorbs multi-"
                         "window skew spikes at ~one window slice of "
                         "extra memory per level")
    ap.add_argument("--output", choices=("frames", "json", "text"),
                    default="frames",
                    help="frames: machine-readable 'FRAME chan t0 hex' "
                         "lines (default; what the scaling bench "
                         "cross-checks); json/text: the full single-host "
                         "decode surface (ACARS/XID/CPDLC) per host")
    ap.add_argument("--station", default="", help="station id for json")
    ap.add_argument("--start-time", type=float, default=None,
                    help="capture start unix time (json/text timestamps)")
    ap.add_argument("--netjson", default=None, metavar="ADDR[:PORT]",
                    help="also send each JSON record via UDP (out.c -j)")
    ap.add_argument("--netsbs", default=None, metavar="ADDR[:PORT]",
                    help="also send SBS position lines via TCP (out.c -s)")
    ap.add_argument("--label-filter", default=None,
                    help="comma list of ACARS labels to keep (main.c -b)")
    args = ap.parse_args(argv)

    from ..compile_cache import enable_compile_cache

    enable_compile_cache()

    # clean-stop drain: SIGTERM/SIGQUIT (sent to ALL workers by the job
    # manager) sets a flag honored at window boundaries — the in-flight
    # window (which every process has already dispatched, by the loop
    # structure) is fetched, emitted, and checkpointed before exit, so a
    # restart resumes exactly-once.  A worker stopped alone leaves its
    # peers to fail on their next collective; their checkpoints are
    # still consistent (written post-emit).
    stop_requested = False

    def _request_stop(signum, frame):
        nonlocal stop_requested
        stop_requested = True

    import signal as _signal
    import threading as _threading

    if _threading.current_thread() is _threading.main_thread():
        for _sig in (_signal.SIGTERM, getattr(_signal, "SIGQUIT", None)):
            if _sig is not None:
                try:
                    _signal.signal(_sig, _request_stop)
                except (ValueError, OSError):
                    pass
        # ops/debug aid: SIGUSR1 dumps every thread's Python stack to a
        # per-process file (a hung collective is otherwise opaque — the
        # runtime threads sit in futex waits with no Python-level trace)
        dump_dir = os.environ.get("VDLM2_STACKDUMP_DIR")
        if dump_dir and hasattr(_signal, "SIGUSR1"):
            import faulthandler

            _dump_f = open(os.path.join(
                dump_dir, f"stacks_p{args.process_id}_{os.getpid()}.txt"),
                "w")
            faulthandler.register(_signal.SIGUSR1, file=_dump_f,
                                  all_threads=True)

    import jax

    initialize(args.coordinator, args.num_processes, args.process_id)

    n_dev = len(jax.devices())
    n_time = args.time_shards or (n_dev // args.chan_shards)
    mesh = global_mesh(args.chan_shards, n_time)
    t_shards_per_host = n_time // args.num_processes
    assert t_shards_per_host * args.num_processes == n_time, (
        "time shards must divide evenly across processes"
    )

    def make_dec(raw_f_offsets=None, lo_wrap=True):
        return MultiHostDecoder(
            mesh,
            max_candidates=args.max_candidates,
            max_symbols=args.max_symbols,
            max_out=args.max_out,
            raw_f_offsets=raw_f_offsets,
            fs=args.fs,
            lo_wrap=lo_wrap,
        )

    from ..pipeline import Pipeline, PipelineConfig

    prev_end: dict[int, int] = {}

    # fail fast on flag combinations that would be silently inert
    if args.checkpoint and not args.block_seconds:
        ap.error("--checkpoint requires --block-seconds (windowed mode)")
    if args.abort_after_window >= 0 and not args.block_seconds:
        ap.error("--abort-after-window requires --block-seconds")
    fdec_active = (args.output != "frames" or args.netjson or args.netsbs)
    if args.label_filter and not fdec_active:
        ap.error("--label-filter needs --output json|text or a net sink "
                 "(FRAME lines are unfiltered by design)")
    if (args.station or args.start_time is not None) and not fdec_active:
        print("warning: --station/--start-time have no effect on "
              "--output frames without a net sink", file=sys.stderr)

    fdec = None
    if fdec_active:
        # full single-host output surface, one decoded stream per host.
        # Frame ownership is per-shard (the trigger's shard), so streams
        # never overlap and merging = concatenating.  Flight-tracker
        # (route/registration MRU) state is per host: with time sharded
        # across hosts a flight seen in different time windows may hit
        # different trackers — same behaviour as running N reference
        # instances on split captures; aggregate downstream if needed.
        from ..host.decoder import FrameDecoder
        from ..host.output import OutputConfig

        fdec = FrameDecoder(
            OutputConfig(
                verbose=2 if args.output == "text" else 0,
                jsonout=args.output == "json",
                station_id=args.station,
                net_json_addr=args.netjson,
                net_sbs_addr=args.netsbs,
            ),
            label_filter=args.label_filter,
            time_base=args.start_time,
        )

    def emit(pipe, cands, t_off):
        for b in pipe._finish(cands, t_offset=t_off, prev_end=prev_end):
            if fdec is not None:
                fdec.process_burst(b)
            if args.output == "frames":
                for fr in b.frames:
                    print(f"FRAME {b.channel} {b.t0} {bytes(fr).hex()}",
                          flush=True)

    if args.y_npy is not None:
        dec = make_dec()
        y = np.load(args.y_npy)                      # (C, T) complex
        t_local = y.shape[1] // args.num_processes
        lo = args.process_id * t_local
        y_local = y[:, lo : lo + t_local]
        freqs_hz = [0.0] * y.shape[0]
        cands_blocks = [(dec.decode_local(y_local), 0)]
        n_cands = len(cands_blocks[0][0])
    else:
        from ..io.sdr import CaptureReader, choose_fc, choose_fc_airspy
        from ..ops.channelizer import Channelizer

        real_input = args.format == "f32real"
        freqs_hz = [f * 1e6 for f in args.freqs]
        if args.fc is not None:
            fc = args.fc
        elif real_input:
            fc = choose_fc_airspy([int(f) for f in freqs_hz], args.fs)
        else:
            fc = choose_fc([int(f) for f in freqs_hz], args.fs)
        reader = CaptureReader(args.iq, args.format)
        # airspy-style real captures put the band at fc + fs/4
        # (pipeline.py builds the single-host channelizer the same way)
        f0 = fc + args.fs / 4 if real_input else fc
        f_offsets = [f - f0 for f in freqs_hz]
        ch = Channelizer(f_offsets, fs=args.fs,
                         real_input=real_input, impl=args.chan_impl)
        p_in, p_out = ch.p_in, ch.p_out
        periods = len(reader) // p_in
        n_cands = 0
        cands_blocks = []
        # raw ingest: channelize inside the collective program (the dense
        # matmul body).  The dft/pfb residue-space impls keep the
        # two-hop path (their tables aren't in the shard body yet);
        # matmul is the worker default.
        raw_ingest = args.chan_impl == "matmul"
        dec = make_dec(raw_f_offsets=f_offsets if raw_ingest else None,
                       lo_wrap=ch.lo_wrap)

        import time as _time

        phase_s = {"channelize": 0.0, "collective_decode": 0.0,
                   "finish": 0.0}

        def dispatch_span(lo_p: int, span_p: int):
            """Enqueue the decode of [lo_p, lo_p+span_p) periods across the
            mesh: this process reads only ITS period sub-slice (local
            file read, no cross-host raw traffic) and dispatches the
            collective WITHOUT blocking on the result.  With raw ingest
            the slice goes up as raw planes and channelizes inside the
            sharded program; otherwise it is channelized on device,
            fetched and re-uploaded (dft/pfb fallback)."""
            per_host = span_p // args.num_processes
            my_lo = lo_p + args.process_id * per_host
            x = reader.read(my_lo * p_in, per_host * p_in)
            tc = _time.monotonic()
            if raw_ingest:
                from ..ops.demod import pack_complex

                if np.iscomplexobj(x):
                    xp = pack_complex(x)
                else:                        # f32real: imag plane is zero
                    xp = np.stack([x.astype(np.float32),
                                   np.zeros_like(x, np.float32)], axis=-1)
                phase_s["channelize"] += _time.monotonic() - tc
                return dec.dispatch_raw(xp, lo_p)
            y_local = np.asarray(ch(x, period0=my_lo))
            phase_s["channelize"] += _time.monotonic() - tc
            return dec.dispatch(y_local)

        def fetch_span(out):
            tc = _time.monotonic()
            cands = dec.fetch(out)
            phase_s["collective_decode"] += _time.monotonic() - tc
            return cands

        def decode_span(lo_p: int, span_p: int):
            return fetch_span(dispatch_span(lo_p, span_p))

        pipe = Pipeline(PipelineConfig(
            freqs_hz=freqs_hz, fs=args.fs, fc_hz=float(fc),
            real_input=real_input, max_symbols=args.max_symbols,
        ))
        if not args.block_seconds:
            per_host = periods // args.num_processes
            per_host -= per_host % t_shards_per_host
            span_p = per_host * args.num_processes
            cands = decode_span(0, span_p)
            emit(pipe, cands, 0)
            n_cands = len(cands)
        else:
            # windowed streaming: overlapping extended windows (core +
            # halo margins, like the single-host stream); window-edge
            # shards see zero halos only in regions the core filter
            # discards, so every owned burst has real margins; memory per
            # host = one window slice.  Windows are DOUBLE-BUFFERED:
            # window w+1 is channelized and dispatched before window w's
            # result is fetched, so the per-window collective rendezvous
            # and the cross-process skew of emit/file-IO overlap with
            # compute instead of landing on the critical path
            # (SCALING.md's measured ~170 ms/window gap at P=2).
            from ..pipeline import stream_geometry

            lmarg_p, _rm, core_p, total_p = stream_geometry(
                p_in, p_out, args.fs, args.max_symbols, args.block_seconds,
                align=args.num_processes * t_shards_per_host)
            lmarg_dec = lmarg_p * p_out
            core_dec = core_p * p_out
            n_win = -(-periods // core_p)
            t_warm = None

            import json as _json

            # checkpoint/resume: my_done = last window THIS host emitted
            # and persisted.  Every host must replay the same collective
            # sequence, so the shared resume point is the allgather-min of
            # per-host cursors; a host ahead of it re-decodes those
            # windows (fetch keeps the collectives aligned) but skips
            # re-emitting them.  Output is exactly-once per host under a
            # clean stop (SIGTERM drain, --abort-after-window); a hard
            # kill between emit and the checkpoint rename re-emits AT MOST
            # the one in-flight window on restart (at-least-once) — the
            # same contract as any emit-then-ack stream.
            ckpt_path = (f"{args.checkpoint}.p{args.process_id}"
                         if args.checkpoint else None)
            # the guard must pin EVERYTHING that changes window content or
            # channel-index meaning: prev_end keys are channel indices and
            # FRAME lines carry them, so a reordered/changed frequency
            # plan (or fc/format/impl/window size) would silently corrupt
            # a resume that only checked the window geometry
            geom = {"core_p": core_p, "n_win": n_win,
                    "num_processes": args.num_processes,
                    "capture_samples": len(reader), "fs": args.fs,
                    "freqs_hz": [float(f) for f in freqs_hz],
                    "fc": float(fc), "format": args.format,
                    "chan_impl": args.chan_impl,
                    "max_symbols": args.max_symbols}
            my_done = -1
            if ckpt_path and os.path.exists(ckpt_path):
                from ..host.checkpoint import load_checkpoint
                from ..host.flights import FlightTracker

                tracker = fdec.flights if fdec is not None else FlightTracker()
                my_done, extra = load_checkpoint(ckpt_path, tracker)
                if extra.get("geom") != geom:
                    raise SystemExit(
                        f"checkpoint {ckpt_path} was written with a "
                        f"different job geometry ({extra.get('geom')} vs "
                        f"{geom}); resuming would lose or duplicate "
                        "frames — use the original flags or remove the "
                        "checkpoint")
                prev_end.update({int(k): int(v)
                                 for k, v in extra["prev_end"].items()})
            if args.num_processes > 1:
                from jax.experimental import multihost_utils

                done_all = multihost_utils.process_allgather(
                    np.asarray([my_done], np.int32))
                resume_w = int(done_all.min()) + 1
            else:
                resume_w = my_done + 1

            n_timed = 0              # windows finished after warmup

            def finish_window(wi: int, out) -> int:
                nonlocal n_timed
                cands = [cd for cd in fetch_span(out)
                         if lmarg_dec <= cd["t0"] < lmarg_dec + core_dec]
                # replayed windows (wi <= my_done) still count as timed:
                # their samples were fetched and decoded, only emit is
                # skipped — excluding them would overstate a resumed
                # run's per-window throughput in STATS
                if wi != resume_w:
                    n_timed += 1
                if wi <= my_done:
                    # replayed for collective alignment only: this host
                    # already emitted it (prev_end from the checkpoint
                    # carries its burst-span suppression, and the flight
                    # tracker state was restored from the checkpoint)
                    return 0
                tf0 = _time.monotonic()
                emit(pipe, cands, wi * core_dec - lmarg_dec)
                phase_s["finish"] += _time.monotonic() - tf0
                if ckpt_path:
                    from ..host.checkpoint import save_checkpoint
                    from ..host.flights import FlightTracker

                    save_checkpoint(
                        ckpt_path, wi,
                        fdec.flights if fdec is not None else FlightTracker(),
                        extra={"geom": geom,
                               "prev_end": {str(k): int(v)
                                            for k, v in prev_end.items()}})
                return len(cands)

            # --abort-after-window N clamps the window range: window N is
            # finished by the tail flush below and nothing further is
            # dispatched, so all processes exit with no collective in
            # flight
            stop_w = n_win
            if 0 <= args.abort_after_window < n_win:
                stop_w = args.abort_after_window + 1
            from collections import deque

            depth = max(1, args.dispatch_depth)
            pending: deque = deque()   # (wi, in-flight dispatch), oldest first
            for wi in range(resume_w, stop_w):
                if stop_requested:
                    # SIGTERM drain: stop dispatching; the tail flush
                    # below finishes (fetch+emit+checkpoint) the pending
                    # windows, which every process has already dispatched
                    break
                out = dispatch_span(wi * core_p - lmarg_p, total_p)
                if wi == resume_w:
                    # the first (resumed) window carries the compile and
                    # is finished synchronously; the collective aligns
                    # all processes, making this the warmup boundary
                    n_cands += finish_window(wi, out)
                    t_warm = _time.monotonic()
                    for k in phase_s:
                        phase_s[k] = 0.0
                else:
                    pending.append((wi, out))
                    if len(pending) >= depth:
                        n_cands += finish_window(*pending.popleft())
            while pending:
                n_cands += finish_window(*pending.popleft())
            if args.timing and t_warm is not None and n_timed:
                print("STATS " + _json.dumps({
                    "pid": args.process_id,
                    "timed_s": _time.monotonic() - t_warm,
                    "timed_windows": n_timed,
                    "global_samples_per_window": core_p * p_in,
                    "phase_s": {k: round(v, 3)
                                for k, v in phase_s.items()},
                }), flush=True)
        print(f"DONE {args.process_id} {n_cands}", flush=True)
        return 0

    pipe = Pipeline(PipelineConfig(
        freqs_hz=freqs_hz or [136_975_000.0],
        fs=args.fs, fc_hz=args.fc or 0.0,
        max_symbols=args.max_symbols,
    ))
    for cands, t_off in cands_blocks:
        emit(pipe, cands, t_off)
    print(f"DONE {args.process_id} {n_cands}", flush=True)
    return 0


# -- local test launcher ---------------------------------------------------------
def launch_local(num_processes: int, worker_args: list[str],
                 local_devices: int = 4, timeout: float = 600.0,
                 cpu_sets: list[str] | None = None):
    """Spawn num_processes workers on this machine, returning each
    process's stdout.  This is a CPU-only emulation: every worker runs
    with JAX_PLATFORMS=cpu on local_devices virtual CPU devices, so no
    worker touches a GPU (a JAX process reserves most of a card's memory,
    so a launcher for GPUs pins each process to its own card instead, e.g.
    through CUDA_VISIBLE_DEVICES).  The cross-process path is real:
    processes talk through the jax.distributed service + Gloo collectives.  cpu_sets pins
    worker i to taskset set cpu_sets[i] (disjoint sets emulate N
    single-host machines honestly for scaling measurements)."""
    import socket
    import subprocess
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    files = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={local_devices}"
        ).strip()
        env["JAX_PLATFORMS"] = "cpu"
        pin = (["taskset", "-c", cpu_sets[pid]] if cpu_sets else [])
        # stdout/stderr go to FILES, not pipes: this launcher joins the
        # workers one at a time, and a worker whose un-drained pipe fills
        # (64 KB — a 16 s / 8 ch capture's FRAME lines alone exceed it)
        # blocks mid-emit, never joins its next collective, and stalls
        # every OTHER worker inside the rendezvous — a deterministic
        # cross-process deadlock that looks like a Gloo hang (r4 scaling
        # sweep; the worker stacks showed emit() blocked on write vs
        # dispatch() blocked in the collective).  Files have no
        # backpressure, matching production where each host owns its
        # stdout.
        of = tempfile.TemporaryFile()
        ef = tempfile.TemporaryFile()
        files.append((of, ef))
        procs.append(subprocess.Popen(
            pin + [sys.executable, "-m", "vdlm2dec_tpu.parallel.multihost",
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(num_processes),
                   "--process-id", str(pid)] + worker_args,
            stdout=of, stderr=ef, env=env,
        ))
    outs = []
    # one shared deadline for the whole job, not a fresh `timeout` per
    # worker: sequential waits let N workers each hanging just under the
    # limit run ~N x timeout wall before cleanup fired
    deadline = time.monotonic() + timeout
    try:
        for p, (of, ef) in zip(procs, files):
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
            of.seek(0)
            ef.seek(0)
            out, err = of.read(), ef.read()
            if p.returncode != 0:
                raise RuntimeError(
                    f"worker failed ({p.returncode}):\n{err.decode()[-2000:]}"
                )
            outs.append(out.decode())
    finally:
        # never leave live workers behind (a timeout used to orphan the
        # whole job: TimeoutExpired propagated with children still running)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for of, ef in files:
            of.close()
            ef.close()
    return outs


if __name__ == "__main__":
    sys.exit(_worker_main())
