"""Multi-host decode: 2 real processes x 4 virtual CPU devices.

Proves the SCALING.md recipe executable end to end: a global (chan=1,
time=8) mesh spanning two jax.distributed processes, cross-process halo
exchange (Gloo), per-host candidate ownership — and a burst whose demod
window CROSSES the process boundary decodes bit-identically to a
single-process run of the same mesh.
"""
import re

import numpy as np
import pytest

from vdlm2dec_tpu import modulator as mod
from vdlm2dec_tpu.parallel.multihost import launch_local

N_TIME = 8
T_SHARD = 4200
T_TOTAL = N_TIME * T_SHARD           # 33600 decimated samples, 0.4 s
SEAM = T_TOTAL // 2                  # process boundary (shards 0-3 | 4-7)


def _frames(outs):
    got = set()
    by_proc = []
    for out in outs:
        fr = set()
        for line in out.splitlines():
            m = re.match(r"FRAME (\d+) (\d+) ([0-9a-f]+)", line)
            if m:
                fr.add((int(m.group(1)), int(m.group(2)), m.group(3)))
        by_proc.append(fr)
        got |= fr
    return got, by_proc


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    rng = np.random.default_rng(7)
    contents = [rng.integers(0, 256, 30).astype(np.uint8),
                rng.integers(0, 256, 40).astype(np.uint8),
                rng.integers(0, 256, 25).astype(np.uint8)]
    # burst 1 inside p0; burst 2 triggers just BEFORE the process seam so
    # its demod window needs p1's samples across processes; burst 3 inside p1
    starts = [3000, SEAM - 500, SEAM + 9000]
    sig = np.zeros(T_TOTAL, dtype=np.complex128)
    for st, c in zip(starts, contents):
        sig += mod.synthesize_baseband(mod.make_burst([c]), start=st,
                                       total=T_TOTAL)
    sig = mod.awgn(sig, 15.0, rng)
    y = np.stack([sig, sig]).astype(np.complex64)     # 2 channels
    path = tmp_path_factory.mktemp("mh") / "y.npy"
    np.save(path, y)
    return str(path)


def test_two_process_seam_matches_single_process(capture):
    worker_args = ["--y-npy", capture, "--time-shards", str(N_TIME),
                   "--max-symbols", "512", "--max-candidates", "4"]
    outs2 = launch_local(2, worker_args, local_devices=4)
    outs1 = launch_local(1, worker_args, local_devices=8)

    frames2, by_proc = _frames(outs2)
    frames1, _ = _frames(outs1)
    # all three bursts decode on both channels
    assert len(frames1) == 6
    # bit-identical across the process count
    assert frames2 == frames1
    # ownership: the seam burst's trigger is in p0's last shard, so p0
    # emits it (demodulated from p1's halo samples across processes)
    seam_frames = {f for f in frames2 if SEAM - 600 < f[1] < SEAM}
    assert seam_frames and seam_frames <= by_proc[0]
    # p1 emits the burst in its own region
    assert any(f[1] > SEAM for f in by_proc[1])


def test_windowed_streaming_matches_oneshot(tmp_path):
    """Worker --block-seconds streams overlapping windows across the mesh
    (constant memory/host); a burst near a window boundary decodes
    identically to the one-shot decode of the whole capture."""
    from vdlm2dec_tpu import modulator as mod2
    from vdlm2dec_tpu.io.sdr import write_capture

    rng = np.random.default_rng(17)
    fs = 2_000_000
    # 3 windows of 0.25 s; p_in=2000 -> core_p=250
    t_raw = 3 * 250 * 2000
    total_dec = t_raw * 84 // 2000
    sig = np.zeros(total_dec, dtype=np.complex128)
    # burst 2 triggers just before the first window boundary (21000 dec)
    for st, nb in ((3000, 30), (20_700, 40), (47_000, 25)):
        c = rng.integers(0, 256, nb).astype(np.uint8)
        sig += mod2.synthesize_baseband(mod2.make_burst([c]), start=st,
                                        total=total_dec)
    wide = mod2.upsample_to_wideband(sig, fs, 75_000.0, total=t_raw) * 30
    wide += rng.normal(size=t_raw) + 1j * rng.normal(size=t_raw)
    cap = str(tmp_path / "mh_stream.cu8")
    write_capture(cap, wide, "cu8")

    base = ["--iq", cap, "--fc", "136900000", "136.975",
            "--time-shards", "8", "--max-symbols", "512",
            "--max-candidates", "4"]
    outs_stream = launch_local(2, base + ["--block-seconds", "0.25"],
                               local_devices=4)
    outs_oneshot = launch_local(2, base, local_devices=4)
    streamed, _ = _frames(outs_stream)
    oneshot, _ = _frames(outs_oneshot)
    assert len(oneshot) == 3
    assert streamed == oneshot


def test_worker_json_output_surface(tmp_path):
    """--output json routes each host's owned bursts through the full
    single-host FrameDecoder surface: the ACARS payload comes out as the
    same JSON line the CLI would print, exactly once across hosts."""
    import json

    from vdlm2dec_tpu import framegen as fg
    from vdlm2dec_tpu import modulator as mod2
    from vdlm2dec_tpu.io.sdr import write_capture

    rng = np.random.default_rng(23)
    fs = 2_000_000
    t_raw = 250 * 2000
    total_dec = t_raw * 84 // 2000
    c = fg.acars_frame(text="MHJSON", label="Q0")
    sig = mod2.synthesize_baseband(mod2.make_burst([c]), start=4000,
                                   total=total_dec)
    wide = mod2.upsample_to_wideband(sig, fs, 75_000.0, total=t_raw) * 30
    wide += rng.normal(size=t_raw) + 1j * rng.normal(size=t_raw)
    cap = str(tmp_path / "mh_json.cu8")
    write_capture(cap, wide, "cu8")

    outs = launch_local(
        2,
        ["--iq", cap, "--fc", "136900000", "136.975",
         "--time-shards", "8", "--max-symbols", "512",
         "--max-candidates", "4",
         "--output", "json", "--station", "MH", "--start-time", "1e9"],
        local_devices=4,
    )
    recs = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("{"):
                recs.append(json.loads(line))
    assert len(recs) == 1
    (rec,) = recs
    assert rec["text"] == "MHJSON"
    assert rec["station_id"] == "MH"
    assert rec["freq"] == 136.975
    # no raw FRAME lines in decoded-output mode
    assert not any("FRAME " in out for out in outs)

    # text mode renders the reference-format block on the owning host
    outs = launch_local(
        2,
        ["--iq", cap, "--fc", "136900000", "136.975",
         "--time-shards", "8", "--max-symbols", "512",
         "--max-candidates", "4", "--output", "text"],
        local_devices=4,
    )
    joined = "\n".join(outs)
    assert "ACARS" in joined and "MHJSON" in joined
    assert "Message :" in joined


def test_worker_netjson_udp_alongside_frames(tmp_path):
    """--netjson on the worker sends each owned frame's JSON record over
    UDP (out.c -j semantics) while stdout keeps the machine-readable
    FRAME lines (default --output frames)."""
    import json
    import socket

    from vdlm2dec_tpu import framegen as fg
    from vdlm2dec_tpu import modulator as mod2
    from vdlm2dec_tpu.io.sdr import write_capture

    rng = np.random.default_rng(29)
    fs = 2_000_000
    t_raw = 250 * 2000
    total_dec = t_raw * 84 // 2000
    c = fg.acars_frame(text="MHUDP", label="Q0")
    sig = mod2.synthesize_baseband(mod2.make_burst([c]), start=4000,
                                   total=total_dec)
    wide = mod2.upsample_to_wideband(sig, fs, 75_000.0, total=t_raw) * 30
    wide += rng.normal(size=t_raw) + 1j * rng.normal(size=t_raw)
    cap = str(tmp_path / "mh_udp.cu8")
    write_capture(cap, wide, "cu8")

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(60)
    port = rx.getsockname()[1]

    outs = launch_local(
        2,
        ["--iq", cap, "--fc", "136900000", "136.975",
         "--time-shards", "8", "--max-symbols", "512",
         "--max-candidates", "4",
         "--netjson", f"127.0.0.1:{port}", "--station", "MH"],
        local_devices=4,
    )
    frames, _ = _frames(outs)
    assert len(frames) == 1            # FRAME lines still on stdout
    data, _ = rx.recvfrom(65536)
    rx.close()
    obj = json.loads(data.decode())
    assert obj["text"] == "MHUDP"
    assert obj["station_id"] == "MH"


def test_worker_checkpoint_resume_exactly_once(tmp_path):
    """Abort a 2-process windowed decode after window 1 (per-host
    checkpoints written), relaunch with the same checkpoint: the union of
    both runs' frames equals an uninterrupted run's, with every frame
    emitted exactly once (no window re-emitted, none lost)."""
    from collections import Counter

    from vdlm2dec_tpu import modulator as mod2
    from vdlm2dec_tpu.io.sdr import write_capture

    from vdlm2dec_tpu import framegen as fg

    rng = np.random.default_rng(41)
    fs = 2_000_000
    n_win = 5
    t_raw = n_win * 250 * 2000
    total_dec = t_raw * 84 // 2000
    sig = np.zeros(total_dec, dtype=np.complex128)
    # one ACARS burst per window (valid app payloads so the decoded-output
    # resume check below gets JSON records), incl. one just before the
    # window-2/3 seam
    for st in (3000, 25_000, 46_500, 62_700, 88_000):
        c = fg.acars_frame(text=f"CKPT{st}", label="Q0")
        sig += mod2.synthesize_baseband(mod2.make_burst([c]), start=st,
                                        total=total_dec)
    wide = mod2.upsample_to_wideband(sig, fs, 75_000.0, total=t_raw) * 30
    wide += rng.normal(size=t_raw) + 1j * rng.normal(size=t_raw)
    cap = str(tmp_path / "mh_ckpt.cu8")
    write_capture(cap, wide, "cu8")

    base = ["--iq", cap, "--fc", "136900000", "136.975",
            "--time-shards", "8", "--max-symbols", "512",
            "--max-candidates", "4", "--block-seconds", "0.25"]
    ckpt = str(tmp_path / "ckpt")

    def frame_counts(outs):
        cnt = Counter()
        for out in outs:
            for line in out.splitlines():
                if line.startswith("FRAME "):
                    cnt[line] += 1
        return cnt

    ref = frame_counts(launch_local(2, base, local_devices=4))
    assert len(ref) == 5 and set(ref.values()) == {1}

    part1 = frame_counts(launch_local(
        2, base + ["--checkpoint", ckpt, "--abort-after-window", "1"],
        local_devices=4))
    assert part1          # windows 0-1 hold at least the first burst
    import os as _os
    assert _os.path.exists(ckpt + ".p0") and _os.path.exists(ckpt + ".p1")

    part2 = frame_counts(launch_local(
        2, base + ["--checkpoint", ckpt], local_devices=4))
    total = part1 + part2
    assert total == ref   # same frames, each exactly once across both runs

    # a further restart from the completed checkpoint re-emits nothing
    part3 = frame_counts(launch_local(
        2, base + ["--checkpoint", ckpt], local_devices=4))
    assert not part3

    # the decoded-output surface resumes identically too (checkpoint
    # carries the flight-tracker state, deterministic --start-time)
    jbase = base + ["--output", "json", "--start-time", "1e9"]

    def json_counts(outs):
        cnt = Counter()
        for out in outs:
            for line in out.splitlines():
                if line.startswith("{"):
                    cnt[line] += 1
        return cnt

    jref = json_counts(launch_local(2, jbase, local_devices=4))
    assert jref
    ckpt_j = str(tmp_path / "ckpt_json")
    j1 = json_counts(launch_local(
        2, jbase + ["--checkpoint", ckpt_j, "--abort-after-window", "1"],
        local_devices=4))
    j2 = json_counts(launch_local(
        2, jbase + ["--checkpoint", ckpt_j], local_devices=4))
    assert j1 + j2 == jref


def test_worker_formats_cs16_and_f32real(tmp_path):
    """The worker decodes every CLI capture format, not just cu8:
    cs16 (complex int16) and the airspy-style f32real arrangement
    (channels at fc + fs/4, imaginary plane zeroed)."""
    from vdlm2dec_tpu import framegen as fg
    from vdlm2dec_tpu import modulator as mod2
    from vdlm2dec_tpu.io.sdr import write_capture

    rng = np.random.default_rng(31)
    fs = 2_000_000
    t_raw = 250 * 2000
    total_dec = t_raw * 84 // 2000

    # cs16: same complex stimulus as the cu8 tests, int16 wire format
    c16 = fg.acars_frame(text="CS16FMT", label="Q0")
    sig = mod2.synthesize_baseband(mod2.make_burst([c16]), start=4000,
                                   total=total_dec)
    wide = mod2.upsample_to_wideband(sig, fs, 75_000.0, total=t_raw) * 900
    wide += 30 * (rng.normal(size=t_raw) + 1j * rng.normal(size=t_raw))
    cap16 = str(tmp_path / "mh.cs16")
    write_capture(cap16, wide, "cs16")
    outs = launch_local(
        2,
        ["--iq", cap16, "--format", "cs16", "--fc", "136900000",
         "136.975", "--time-shards", "8", "--max-symbols", "512",
         "--max-candidates", "4"],
        local_devices=4,
    )
    frames, _ = _frames(outs)
    assert len(frames) == 1
    assert bytes.fromhex(next(iter(frames))[2])[1:-3] == bytes(c16)

    # f32real: real capture, channel at fo = freq - (fc + fs/4)
    freq, fc = 136_975_000, 136_800_000
    fo = freq - (fc + fs / 4)
    cre = fg.acars_frame(text="REALFMT", label="Q0")
    bb = mod2.synthesize_baseband(mod2.make_burst([cre]), start=4000,
                                  total=total_dec)
    ratio = fs / 84_000
    n = t_raw
    tt = np.arange(n) / ratio
    i0 = np.clip(np.floor(tt).astype(int), 0, len(bb) - 2)
    frac = tt - i0
    up = bb[i0] * (1 - frac) + bb[i0 + 1] * frac
    real_sig = 2.0 * np.real(
        up * np.exp(1j * 2 * np.pi * fo / fs * np.arange(n)))
    real_sig = (real_sig * 30 + rng.normal(size=n)).astype(np.float32)
    capf = str(tmp_path / "mh.f32")
    write_capture(capf, real_sig, "f32real")
    outs = launch_local(
        2,
        ["--iq", capf, "--format", "f32real", "--fc", str(fc),
         "136.975", "--time-shards", "8", "--max-symbols", "512",
         "--max-candidates", "4"],
        local_devices=4,
    )
    frames, _ = _frames(outs)
    assert len(frames) == 1
    assert bytes.fromhex(next(iter(frames))[2])[1:-3] == bytes(cre)


def test_dispatch_depth_frame_parity(tmp_path):
    """--dispatch-depth deepens the in-flight window pipeline (hides the
    per-window collective rendezvous); it must not change WHAT is
    decoded.  Depth 1 (fetch-before-next-dispatch), 2 (the default
    double-buffering) and 3 produce identical frame sets."""
    from vdlm2dec_tpu import modulator as mod2
    from vdlm2dec_tpu.io.sdr import write_capture

    rng = np.random.default_rng(23)
    fs = 2_000_000
    t_raw = 6 * 250 * 2000            # 6 windows of 0.25 s
    total_dec = t_raw * 84 // 2000
    sig = np.zeros(total_dec, dtype=np.complex128)
    for st in range(2500, total_dec - 3000, 9000):
        c = rng.integers(0, 256, 25).astype(np.uint8)
        sig += mod2.synthesize_baseband(mod2.make_burst([c]), start=st,
                                        total=total_dec)
    wide = mod2.upsample_to_wideband(sig, fs, 75_000.0, total=t_raw) * 30
    wide += rng.normal(size=t_raw) + 1j * rng.normal(size=t_raw)
    cap = str(tmp_path / "mh_depth.cu8")
    write_capture(cap, wide, "cu8")

    base = ["--iq", cap, "--fc", "136900000", "136.975",
            "--time-shards", "8", "--max-symbols", "512",
            "--max-candidates", "8", "--block-seconds", "0.25"]
    got = {}
    for depth in (1, 2, 3):
        outs = launch_local(2, base + ["--dispatch-depth", str(depth)],
                            local_devices=4)
        got[depth], _ = _frames(outs)
    assert got[1] and got[1] == got[2] == got[3]


def test_token_chained_dispatch_serializes_collective_programs():
    """MultiHostDecoder.dispatch chains a zero-valued token from each
    collective program's output into the next program's input: with
    dispatch_depth >= 2 two programs with Gloo collectives are in flight
    per process, and without the data dependency XLA-CPU may enter them
    in different orders on different processes (rare futex deadlock seen
    in the r4 scaling sweep).  The token must (a) thread a fresh output
    array through every dispatch, (b) stay exactly 0.0 so the y + tok add
    is an f32 identity, and (c) leave decoded candidates identical to the
    pre-token path (covered by the cross-process parity tests; here the
    single-process mesh pins candidate content with two windows in
    flight at once)."""
    from vdlm2dec_tpu.parallel.multihost import MultiHostDecoder, global_mesh

    rng = np.random.default_rng(5)
    t_total = 8 * 4200
    content = rng.integers(0, 256, 25).astype(np.uint8)
    sig = np.zeros(t_total, dtype=np.complex128)
    sig += mod.synthesize_baseband(mod.make_burst([content]), start=9000,
                                   total=t_total)
    sig = (sig * 20 + rng.normal(size=t_total)
           + 1j * rng.normal(size=t_total)).astype(np.complex64)

    mesh = global_mesh(1, 8)
    dec = MultiHostDecoder(mesh, max_candidates=2, max_symbols=512)
    assert dec._tok is None
    # depth-2 pattern: both windows dispatched before either fetch
    out0 = dec.dispatch(sig[None, :])
    tok0 = dec._tok
    assert tok0 is not None
    out1 = dec.dispatch(sig[None, :])
    assert dec._tok is not tok0                 # fresh token per program
    c0 = dec.fetch(out0)
    c1 = dec.fetch(out1)
    np.testing.assert_array_equal(np.asarray(tok0), 0.0)
    np.testing.assert_array_equal(np.asarray(dec._tok), 0.0)

    frames0 = sorted((c["chan"], c["t0"]) for c in c0)
    assert frames0 == sorted((c["chan"], c["t0"]) for c in c1)
    assert any(8400 <= t0 < 12600 for _, t0 in frames0)
    # identical to the serial (fetch-each) path
    serial = dec.decode_local(sig[None, :])
    assert sorted((c["chan"], c["t0"]) for c in serial) == frames0
