"""Full pipeline tests: wideband IQ -> channelizer -> demod -> frames."""
import numpy as np
import pytest

from vdlm2dec_tpu import modulator as mod
from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig


def _mk_frame(rng, n=30):
    return rng.integers(0, 256, n).astype(np.uint8)


def test_pipeline_single_channel_baseband():
    rng = np.random.default_rng(0)
    content = _mk_frame(rng)
    plan = mod.make_burst([content])
    sig = mod.synthesize_baseband(plan, start=400, total=8400)
    sig = mod.awgn(sig, 15.0, rng)
    cfg = PipelineConfig(freqs_hz=[136_975_000.0], fc_hz=136_900_000.0,
                         max_symbols=1024, max_candidates=8)
    pipe = Pipeline(cfg)
    bursts = pipe.decode_channels(sig[None, :].astype(np.complex64))
    with_frames = [b for b in bursts if b.frames]
    assert len(with_frames) == 1
    f = with_frames[0].frames[0]
    np.testing.assert_array_equal(f[1:-3], content)
    assert with_frames[0].length_bits == plan.length_bits


def test_pipeline_wideband_8_channels():
    """8 bursts on 8 different 25 kHz channels in one 2 MHz band."""
    rng = np.random.default_rng(1)
    fs = 2_000_000
    freqs = [136_600_000 + 25_000 * i for i in range(0, 16, 2)]
    fc = 136_487_500          # places all channels within the span, off-raster
    cfg = PipelineConfig(freqs_hz=[float(f) for f in freqs], fs=fs,
                         fc_hz=fc, lo_wrap=False,
                         max_symbols=1024, max_candidates=4)
    pipe = Pipeline(cfg)

    total_bb = 12 * 8400
    total_wide = int(total_bb * fs / 84_000)
    wide = np.zeros(total_wide, dtype=np.complex128)
    contents = []
    for ci, f in enumerate(freqs):
        content = _mk_frame(rng, 24 + ci)
        contents.append(content)
        plan = mod.make_burst([content])
        bb = mod.synthesize_baseband(plan, start=500 + 977 * ci, total=total_bb)
        wide += mod.upsample_to_wideband(bb, fs, f - fc, total=total_wide)
    noise = (rng.normal(size=total_wide) + 1j * rng.normal(size=total_wide)) * 0.02
    wide = (wide + noise).astype(np.complex64)

    bursts = pipe.decode_wideband(wide)
    got = {}
    for b in bursts:
        for f in b.frames:
            got[b.channel] = f
    assert sorted(got.keys()) == list(range(8)), f"channels decoded: {sorted(got)}"
    for ci in range(8):
        np.testing.assert_array_equal(got[ci][1:-3], contents[ci])


def test_pipeline_two_bursts_one_channel():
    rng = np.random.default_rng(2)
    c1, c2 = _mk_frame(rng, 20), _mk_frame(rng, 40)
    p1, p2 = mod.make_burst([c1]), mod.make_burst([c2])
    total = 3 * 8400
    sig = (
        mod.synthesize_baseband(p1, start=400, total=total)
        + mod.synthesize_baseband(p2, start=12_000, total=total)
    )
    sig = mod.awgn(sig, 15.0, rng)
    cfg = PipelineConfig(freqs_hz=[136_975_000.0], fc_hz=136_900_000.0,
                         max_symbols=1024, max_candidates=8)
    pipe = Pipeline(cfg)
    bursts = [b for b in pipe.decode_channels(sig[None, :].astype(np.complex64))
              if b.frames]
    assert len(bursts) == 2
    np.testing.assert_array_equal(bursts[0].frames[0][1:-3], c1)
    np.testing.assert_array_equal(bursts[1].frames[0][1:-3], c2)


def test_pipeline_matches_golden_frames():
    """Same capture through golden scalar chain and device pipeline."""
    from vdlm2dec_tpu.golden.dsp import GoldenChannel
    from vdlm2dec_tpu.golden.codec import deframe_block

    rng = np.random.default_rng(3)
    content = _mk_frame(rng, 50)
    plan = mod.make_burst([content])
    sig = mod.synthesize_baseband(plan, start=600, cfo_hz=150.0,
                                  timing_frac=0.35, total=2 * 8400)
    sig = mod.awgn(sig, 12.0, rng)

    gch = GoldenChannel()
    gb = gch.run(sig)
    gold_frames = []
    for b in gb:
        fs_, _ = deframe_block(b.block, b.nbrow, b.nlbyte)
        gold_frames.extend(tuple(f.tolist()) for f in fs_)

    cfg = PipelineConfig(freqs_hz=[136_975_000.0], fc_hz=136_900_000.0,
                         max_symbols=1024, max_candidates=8)
    pipe = Pipeline(cfg)
    bursts = pipe.decode_channels(sig[None, :].astype(np.complex64))
    dev_frames = [tuple(f.tolist()) for b in bursts for f in b.frames]
    assert gold_frames, "golden decoded nothing"
    assert dev_frames == gold_frames


def test_pipeline_max_capacity_burst():
    """A large multi-row burst through the full-capacity demod window
    (max_symbols = MAX_BURST_SYMBOLS, the production default)."""
    from vdlm2dec_tpu.constants import MAX_BURST_SYMBOLS

    rng = np.random.default_rng(9)
    content = rng.integers(0, 256, 900).astype(np.uint8)   # ~4 RS rows
    plan = mod.make_burst([content])
    assert plan.nbrow >= 4
    nsym = len(plan.symbol_phases)
    total = (400 + (nsym + 40) * 8)
    sig = mod.synthesize_baseband(plan, start=400, total=total)
    sig = mod.awgn(sig, 18.0, rng)
    cfg = PipelineConfig(freqs_hz=[136_975_000.0], fc_hz=136_900_000.0,
                         max_symbols=MAX_BURST_SYMBOLS, max_candidates=4)
    pipe = Pipeline(cfg)
    bursts = [b for b in pipe.decode_channels(sig[None, :].astype(np.complex64))
              if b.frames]
    assert len(bursts) == 1
    assert bursts[0].nbrow == plan.nbrow
    np.testing.assert_array_equal(bursts[0].frames[0][1:-3], content)


def test_pipeline_rs_corrects_iq_corruption():
    """Symbols corrupted at IQ level are repaired by RS: frame recovers and
    rs_counts reports corrections."""
    rng = np.random.default_rng(10)
    content = _mk_frame(rng, 300)          # 2 RS rows: the column-major
    plan = mod.make_burst([content])       # interleave spreads adjacent
    assert plan.nbrow == 2                 # corrupted bytes across rows
    sig = mod.synthesize_baseband(plan, start=400, total=3 * 8400)
    # wipe two 3-symbol spans in the data region (after the 17 sync + ~9
    # header symbols): each wrecks ~3 consecutive channel bytes
    for sym in (80, 400):
        a = 400 + sym * 8
        sig[a : a + 24] = 0.1 * (rng.normal(size=24) + 1j * rng.normal(size=24))
    sig = mod.awgn(sig, 18.0, rng)
    cfg = PipelineConfig(freqs_hz=[136_975_000.0], fc_hz=136_900_000.0,
                         max_symbols=1024, max_candidates=4)
    pipe = Pipeline(cfg)
    bursts = [b for b in pipe.decode_channels(sig[None, :].astype(np.complex64))
              if b.frames]
    assert len(bursts) == 1
    np.testing.assert_array_equal(bursts[0].frames[0][1:-3], content)
    assert sum(c for c in bursts[0].rs_counts if c > 0) >= 2


def test_dft_channelizer_matches_matmul():
    """The residue-space ("dft") channelizer computes the same sums as the
    dense wrapped-LO matmul (same products, different order) and decodes
    the same frames through the fused path."""
    import jax.numpy as jnp

    from vdlm2dec_tpu import framegen as fg
    from vdlm2dec_tpu import modulator as mod
    from vdlm2dec_tpu.ops.channelizer import Channelizer

    rng = np.random.default_rng(21)
    fs, fc = 2_000_000, 136_900_000
    freqs = [136_975_000.0, 136_725_000.0]
    total = 200_000
    x = (rng.normal(size=total) + 1j * rng.normal(size=total)).astype(np.complex64)

    offs = [f - fc for f in freqs]
    y_mm = np.asarray(Channelizer(offs, fs=fs)(x))
    y_dft = np.asarray(Channelizer(offs, fs=fs, impl="dft")(x))
    np.testing.assert_allclose(y_dft, y_mm, rtol=2e-5, atol=2e-5)

    # frame-level equality through the fused u8 path
    content = fg.acars_frame(text="DFT PATH", label="Q0")
    bb = mod.synthesize_baseband(mod.make_burst([content]), start=1500,
                                 total=total * 84 // 2000)
    wide = mod.upsample_to_wideband(bb, fs, offs[0], total=total) * 40
    wide += rng.normal(size=total) + 1j * rng.normal(size=total)
    raw = np.empty(2 * total, np.float32)
    raw[0::2] = wide.real + 127.37
    raw[1::2] = wide.imag + 127.37
    raw_u8 = np.clip(np.round(raw), 0, 255).astype(np.uint8)

    frames = {}
    for impl in ("matmul", "dft"):
        cfg = PipelineConfig(freqs_hz=freqs, fs=fs, fc_hz=float(fc),
                             max_symbols=512, max_candidates=4,
                             chan_impl=impl)
        pipe = Pipeline(cfg)
        cands = pipe.decode_wideband_u8(raw_u8)
        bursts = pipe._finish(cands, 0)
        frames[impl] = sorted(
            (b.channel, b.t0, tuple(f.tolist()))
            for b in bursts for f in b.frames
        )
    assert len(frames["matmul"]) == 1
    assert frames["dft"] == frames["matmul"]


def test_chunked_demod_matches_dense():
    """The lax.map-chunked per-candidate demod (engaged above
    DEMOD_CHUNK_GATE, needed for whole-band compiles) produces the same
    packed rows as the dense vmap."""
    import vdlm2dec_tpu.pipeline as P

    rng = np.random.default_rng(33)
    t = 9000
    sig = np.zeros(t, dtype=np.complex128)
    for st in (500, 3500, 6200):
        c = rng.integers(0, 256, 25).astype(np.uint8)
        sig += mod.synthesize_baseband(mod.make_burst([c]), start=st,
                                       total=t)
    sig = mod.awgn(sig, 14.0, rng)
    y = np.stack([sig, sig]).astype(np.complex64)
    from vdlm2dec_tpu.ops.demod import pack_complex

    yp = pack_complex(y)
    dense = np.asarray(P._device_decode_packed(yp, 32, 256, 64))
    gate = P.DEMOD_CHUNK_GATE
    try:
        P.DEMOD_CHUNK_GATE = 1           # force the chunked branch
        chunked = np.asarray(P._device_decode_packed(yp, 32, 256, 64))
    finally:
        P.DEMOD_CHUNK_GATE = gate
    np.testing.assert_array_equal(dense, chunked)


@pytest.mark.parametrize("chan_impl", ["matmul", "dft"])
def test_device_probe_matches_dispatch(chan_impl):
    """bench's chip-bound probe (make_device_probe: staged raw, N salted
    decodes chained in one fori_loop, checksum-only fetch) must run the
    SAME program as the normal fused dispatch: with a zero salt, its
    checksum equals the packed-buffer sum of decode_wideband_u8, and the
    salt loop must not change the decode (salts perturb raw[0] only —
    one sample of one channel's input, below the noise floor)."""
    import jax.numpy as jnp

    from vdlm2dec_tpu.pipeline import make_device_probe

    rng = np.random.default_rng(3)
    content = _mk_frame(rng)
    plan = mod.make_burst([content])
    fs, fc, f = 2_000_000, 136_900_000, 136_975_000
    bb = mod.synthesize_baseband(plan, start=900, total=84_000)
    wide = mod.upsample_to_wideband(bb, fs, f - fc, total=fs) * 40
    wide += (rng.normal(size=fs) + 1j * rng.normal(size=fs))
    inter = np.empty(2 * len(wide), np.float32)
    inter[0::2] = wide.real + 127.37
    inter[1::2] = wide.imag + 127.37
    raw = np.clip(np.round(inter), 0, 255).astype(np.uint8)

    cfg = PipelineConfig(
        freqs_hz=[float(f)], fs=fs, fc_hz=float(fc),
        lo_wrap=True, max_candidates=8, max_symbols=512, max_out=64,
        chan_impl=chan_impl)
    pipe = Pipeline(cfg)
    probe, raw_dev, t = make_device_probe(pipe, raw)

    # reference value: the normal fused dispatch of the same span (a
    # FRESH pipe so the LO period cursor matches the probe's pinned 0)
    from vdlm2dec_tpu.pipeline import _dispatch_fused

    buf = np.asarray(_dispatch_fused(Pipeline(cfg), raw[: 2 * t],
                                     "cu8", 0, 0))
    # the probe checksums the bit-exact portions only (block bytes +
    # integer meta; the float of/df words round differently across XLA
    # program structures)
    want = int(buf[:, :2048].astype(np.uint32).sum()
               + buf[:, 2048:2076].astype(np.uint32).sum()
               + buf[:, 2084:2096].astype(np.uint32).sum())
    cands = pipe.decode_wideband_u8(raw[: 2 * t])
    bursts = pipe._finish(cands, 0)
    frames = [fr for b in bursts for fr in b.frames]
    assert len(frames) == 1
    np.testing.assert_array_equal(frames[0][1:-3], content)

    # salt 0 = the exact dispatch program: checksums must agree
    chk0 = int(np.asarray(probe(raw_dev, jnp.zeros((1,), jnp.uint8))))
    assert chk0 == want
    # every loop iteration decodes the same block: N iterations = N x
    # the single-decode checksum (salts only defeat XLA loop hoisting;
    # a 1-LSB raw perturbation does not change any decoded byte)
    chk1 = int(np.asarray(probe(raw_dev, jnp.full((1,), 5, jnp.uint8))))
    chk3 = int(np.asarray(probe(raw_dev, jnp.arange(3, dtype=jnp.uint8))))
    assert chk1 == want
    assert chk3 == 3 * chk1


def test_chan_impl_auto_resolution():
    """chan_impl="auto" (the default) picks the residue-space dft
    channelizer exactly when the plan is eligible — raster-aligned
    offsets under wrapped-LO boxcar — and falls back to the dense matmul
    otherwise.  dft computes the same products on eligible plans in
    25/84 the FLOPs."""
    from vdlm2dec_tpu.ops.channelizer import resolve_chan_impl
    from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig

    on = [25_000.0 * k for k in (-3, 1, 4)]
    assert resolve_chan_impl(on, 2_000_000, 500) == "dft"
    assert resolve_chan_impl([12_345.0], 2_000_000, 500) == "matmul"
    assert resolve_chan_impl(on, 2_000_000, 500,
                             filter_mode="fir") == "matmul"
    assert resolve_chan_impl(on, 2_000_000, 500,
                             lo_wrap=False) == "matmul"
    # airspy chains: offsets relative to fc + fs/4 stay on the raster
    assert resolve_chan_impl(on, 5_000_000, 1250) == "dft"
    assert resolve_chan_impl(on, 6_000_000, 1500) == "dft"

    # Pipeline resolves into a PRIVATE cfg copy (checkpoint geometry and
    # the wideband wrappers see the concrete impl via pipe.cfg, never
    # "auto"); the caller's cfg keeps its declared intent so reusing it
    # for a second Pipeline re-resolves (ADVICE r4)
    cfg = PipelineConfig(freqs_hz=[136_975_000.0, 136_725_000.0],
                         fc_hz=136_800_000.0, max_symbols=256)
    assert cfg.chan_impl == "auto"
    pipe = Pipeline(cfg)
    assert cfg.chan_impl == "auto"
    assert pipe.cfg.chan_impl == "dft"
    assert pipe.channelizer.impl == "dft"
    cfg2 = PipelineConfig(freqs_hz=[136_975_000.0], fc_hz=136_800_000.0,
                          max_symbols=256, filter_mode="fir")
    assert Pipeline(cfg2).channelizer.impl == "matmul"
