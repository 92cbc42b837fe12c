"""What the GPU bring-up relies on, checked on the CPU.

* every f32 x f32 dot on the decode path states its precision (a GPU runs
  an undeclared f32 dot in TF32, which the CPU tests would never see);
* the persistent compile cache honours JAX_COMPILATION_CACHE_DIR and
  otherwise lives at <checkout>/.jax_cache;
* chip_smoke.py refuses to run without a GPU, and its phases, called
  directly at small shapes, decode everything they synthesize.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

import chip_smoke
from vdlm2dec_tpu import compile_cache
from vdlm2dec_tpu.pipeline import Pipeline, PipelineConfig, make_device_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _undeclared_f32_dots(jaxpr) -> list[str]:
    """dot_generals with two f32 operands and no precision, recursively
    through every sub-jaxpr (jit, scan/map, cond, fori_loop)."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dts = [v.aval.dtype for v in eqn.invars]
            if (all(d == jnp.float32 for d in dts)
                    and eqn.params.get("precision") is None):
                bad.append(str(eqn.source_info.traceback)[-300:])
        for p in eqn.params.values():
            subs = p if isinstance(p, (tuple, list)) else (p,)
            for s in subs:
                if isinstance(s, jcore.ClosedJaxpr):
                    bad += _undeclared_f32_dots(s.jaxpr)
                elif isinstance(s, jcore.Jaxpr):
                    bad += _undeclared_f32_dots(s)
    return bad


def test_precision_walker_flags_an_undeclared_dot():
    def f(a, b):
        return jnp.dot(a, b) + jnp.dot(a, b, precision="highest")

    j = jax.make_jaxpr(jax.jit(f))(jnp.ones((4, 4)), jnp.ones((4, 4)))
    assert len(_undeclared_f32_dots(j.jaxpr)) == 1


@pytest.mark.parametrize("chan_impl", ["matmul", "dft", "pfb"])
def test_decode_path_dots_declare_precision(chan_impl):
    """The whole fused device program (raw cu8 -> channelizer -> sync ->
    demod -> header -> assembly -> RS -> packed rows) for each
    channelizer: no f32 dot is left to the backend's default."""
    freqs = [136_600_000.0 + 50_000.0 * i for i in range(4)]
    cfg = PipelineConfig(freqs_hz=freqs, fc_hz=136_700_000.0,
                         max_symbols=256, max_candidates=8,
                         chan_impl=chan_impl)
    pipe = Pipeline(cfg)
    raw = np.full(2 * 20 * pipe.channelizer.p_in, 127, np.uint8)
    probe, raw_dev, _ = make_device_probe(pipe, raw)
    j = jax.make_jaxpr(probe)(raw_dev, jnp.zeros((1,), jnp.uint8))
    assert _undeclared_f32_dots(j.jaxpr) == []


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the module sets no path of its own
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_station_phase_small(tmp_path):
    res = chip_smoke.phase_station(str(tmp_path), seconds=1.0, max_rows=1,
                                   block_seconds=1.0, compare_cpu=False)
    n = int(res["recall"].split("/")[1])
    assert n > 0 and res["recall"] == f"{n}/{n}" and res["spurious"] == 0


SMALL_BAND = dict(fs=2_000_000, n_channels=16, seconds=0.5, spacing=25_000,
                  active_every=4, base=136_500_000)


def test_chip_smoke_band_phase_small(tmp_path):
    res = chip_smoke.phase_band(str(tmp_path), plan=SMALL_BAND,
                                block_seconds=0.25)
    n = int(res["recall"].split("/")[1])
    assert n > 0 and res["recall"] == f"{n}/{n}" and res["spurious"] == 0


def test_chip_smoke_stages_phase(tmp_path):
    res = chip_smoke.phase_stages(str(tmp_path))
    assert res["header"]["bit_exact"] and res["rs"]["bit_exact"]
    assert res["sync_vs_golden"]["positions"] > 50


def test_chip_smoke_sharded_phase_small(tmp_path):
    """The --four comparison on four virtual CPU devices."""
    res = chip_smoke.phase_sharded(str(tmp_path), plan=SMALL_BAND)
    assert res["equal_to_one_card"]
    n = int(res["recall"].split("/")[1])
    assert n > 0 and res["recall"] == f"{n}/{n}"
