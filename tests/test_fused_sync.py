"""Streaming sync (sync_impl="stream") vs the full-filter path ("xla").

"stream" filters only polyphase branch 0 for the sync metric and lets the
demod filter its own windows inline, so the (C, 4, T, 2) filter tensor is
never built.  It must (a) reproduce the full-filter sync metric to float
tolerance and (b) decode identical frames through the whole pipeline, in
both channelizer modes, with and without bf16 compute.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import bench as B
from vdlm2dec_tpu.ops.demod import (phase_of, polyphase_filter,
                                    polyphase_filter0, sync_scan)
from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig


def test_sync_metric_matches_xla():
    wide, freqs, fc, _truth = B.make_capture(2_000_000, 8, 0.5)
    cfg = PipelineConfig(freqs_hz=[float(f) for f in freqs], fs=2_000_000,
                         fc_hz=float(fc))
    pipe = Pipeline(cfg)
    t = len(wide) - len(wide) % pipe.channelizer.p_in
    y = jnp.asarray(np.asarray(pipe.channelizer(wide[:t])))
    err_x, fr_x = sync_scan(phase_of(polyphase_filter(y)[:, 0]))
    err_s, fr_s = sync_scan(phase_of(polyphase_filter0(y)))
    assert err_s.shape == err_x.shape
    np.testing.assert_allclose(np.asarray(err_s), np.asarray(err_x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(fr_s), np.asarray(fr_x),
                               rtol=1e-4, atol=1e-5)


def _frames(pipe, raw):
    cands = pipe.decode_wideband_u8(raw)
    bursts = pipe._finish(cands, 0)
    return sorted(
        (b.channel, bytes(bytearray(f[1:-3])))
        for b in bursts for f in b.frames
    )


@pytest.mark.parametrize("chan_impl,compute", [
    ("matmul", "f32"),
    ("dft", "f32"),
    ("dft", "bf16"),
])
def test_fused_frame_parity(chan_impl, compute):
    wide, freqs, fc, truth = B.make_capture(2_000_000, 8, 2.0)
    raw = B.to_u8(wide)
    got = {}
    for sync_impl in ("xla", "stream"):
        cfg = PipelineConfig(
            freqs_hz=[float(f) for f in freqs], fs=2_000_000,
            fc_hz=float(fc), lo_wrap=True, chan_impl=chan_impl,
            max_candidates=64, max_symbols=512, max_out=512,
            compute=compute, sync_impl=sync_impl,
        )
        got[sync_impl] = _frames(Pipeline(cfg), raw)
    assert got["xla"] == sorted((c, b) for c, b, *_ in truth)
    assert got["stream"] == got["xla"]


def test_fused_streaming_matches_one_shot():
    """The streaming sync path through the streaming window machinery."""
    wide, freqs, fc, truth = B.make_capture(2_000_000, 8, 2.0)
    raw = B.to_u8(wide)
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=2_000_000, fc_hz=float(fc),
        max_candidates=64, max_symbols=512, max_out=512, sync_impl="stream",
    )
    pipe = Pipeline(cfg)
    frames = sorted(
        (b.channel, bytes(bytearray(f[1:-3])))
        for bs in pipe.stream_wideband_u8(raw, block_seconds=0.5)
        for b in bs for f in b.frames
    )
    assert frames == sorted((c, b) for c, b, *_ in truth)
