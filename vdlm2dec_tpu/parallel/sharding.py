"""Sharded decode: shard_map over a (channel, time) device mesh.

The framework's two parallel axes (SURVEY.md section 2.2):
  * "chan"  — embarrassingly parallel across VDL channels (the reference's
              one-pthread-per-frequency, scaled to thousands of channels);
  * "time"  — overlap-save time-block sharding of each channel's infinite
              sample stream (the reference carries per-sample state instead,
              channel_t in vdlm2.h:56-79).  Neighbouring time shards
              exchange halos over NVLink via lax.ppermute:
                - left halo  (HALO_LEFT samples): matched-filter ring (16) +
                  sync correlation window (128) + trigger hysteresis;
                - right halo (burst window): a burst whose sync trigger lands
                  near the shard end is demodulated from samples owned by the
                  right neighbour.  Ownership rule: the shard containing the
                  trigger owns the burst (dedup happens structurally).

Input IQ at the raw rate needs NO halo: the integrate-and-dump channelizer
is local within each 4*SDRCLK-sample period, so raw blocks are sharded on
exact period boundaries and the halos are exchanged on the cheap 84 kHz
stream (24x less NVLink traffic than raw-rate halos).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.demod import pack_complex

HALO_LEFT = 160          # filter ring + sync window + hysteresis margin


def burst_window(max_symbols: int) -> int:
    return 17 + 7 + 8 * max_symbols


def globalize_t0(buf: jnp.ndarray, shard_off: jnp.ndarray) -> jnp.ndarray:
    """Add a shard's global time offset to the packed t0 meta word
    (bytes 2052:2056 of the pipeline packed-row layout) — shared by every
    shard_map decode body so the rewrite can't drift between them."""
    meta_t0 = jax.lax.bitcast_convert_type(
        buf[:, 2052:2056], jnp.int32
    ) + shard_off          # bitcast of (M, 4) u8 collapses to (M,)
    t0_u8 = jax.lax.bitcast_convert_type(
        meta_t0[:, None], jnp.uint8
    ).reshape(-1, 4)
    return jnp.concatenate([buf[:, :2052], t0_u8, buf[:, 2056:]], axis=1)


def make_mesh(n_chan: int, n_time: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_chan * n_time, (
        f"need {n_chan * n_time} devices, have {devices.size}"
    )
    grid = devices[: n_chan * n_time].reshape(n_chan, n_time)
    return Mesh(grid, axis_names=("chan", "time"))


def _halo_exchange(y: jnp.ndarray, left: int, right: int, axis: str) -> jnp.ndarray:
    """Concatenate neighbours' edge samples around the local block.

    Missing neighbours (stream edges) contribute zeros, matching the
    zero-history behaviour of the scalar chain at stream start.
    """
    n = jax.lax.axis_size(axis)
    parts = []
    if left > 0:
        # receive the last `left` samples of the left neighbour; shards with
        # no sender (stream start) get zeros from ppermute itself
        lh = jax.lax.ppermute(
            y[:, -left:], axis, [(i, i + 1) for i in range(n - 1)]
        )
        parts.append(lh)
    parts.append(y)
    if right > 0:
        rh = jax.lax.ppermute(
            y[:, :right], axis, [(i + 1, i) for i in range(n - 1)]
        )
        parts.append(rh)
    return jnp.concatenate(parts, axis=1)


@dataclass
class ShardedWidebandDecoder:
    """Full sharded step: raw wideband IQ -> channelize -> decode.

    The raw input (T_raw,) is sharded over the "time" axis on exact
    channelizer-period boundaries (4*SDRCLK samples), so channelization is
    purely local; the per-channel 84 kHz streams then exchange halos over
    NVLink and run the decode stages, with channels sharded over "chan".

    Each shard compacts its candidates on device into the packed uint8 row
    format (pipeline._device_decode_packed layout) so the host does ONE
    fetch of a (n_shards*max_out, ROW) buffer — the multi-chip analogue of
    the single-chip fast path.
    """
    mesh: Mesh
    f_offsets: tuple
    fs: int = 2_000_000
    sdrclk: int = 500
    lo_wrap: bool = True
    max_candidates: int = 4
    max_symbols: int = 256
    max_out: int = 64              # packed decode slots per shard

    def __post_init__(self):
        from ..ops.channelizer import aggregation_matrix, lo_tables, period_for

        self.p_in, self.p_out = period_for(self.sdrclk)
        lo, _ = lo_tables(tuple(self.f_offsets), self.fs, self.sdrclk, self.lo_wrap)
        a_np = aggregation_matrix(self.sdrclk)
        n_chan = len(self.f_offsets)
        ang = (
            np.zeros(n_chan, dtype=np.float64)
            if self.lo_wrap
            else 2.0 * np.pi * np.asarray(self.f_offsets) * (self.p_in / self.fs)
        )
        lo_r, lo_i = jnp.asarray(lo.real), jnp.asarray(lo.imag)
        a = jnp.asarray(a_np)
        angj = jnp.asarray(ang, dtype=jnp.float32)

        inner = raw_decode_step(self.max_candidates, self.max_symbols,
                                self.max_out, self.p_in)

        def step(x, lo_r, lo_i, a, ang):
            return inner(x, lo_r, lo_i, a, ang, jnp.float32(0.0))

        out_specs = P(("chan", "time"), None)
        self._step = jax.jit(
            jax.shard_map(
                step,
                mesh=self.mesh,
                in_specs=(
                    P("time", None), P("chan", None), P("chan", None),
                    P(None, None), P("chan"),
                ),
                out_specs=out_specs,
            )
        )
        self._consts = (lo_r, lo_i, a, angj)

    def decode(self, x, observer=None) -> list:
        with self.mesh:
            x = jax.device_put(
                jnp.asarray(
                    pack_complex(x) if np.iscomplexobj(x) else x,
                    dtype=jnp.float32,
                ),
                NamedSharding(self.mesh, P("time", None)),
            )
            lo_r, lo_i, a, ang = self._consts
            sh_c = NamedSharding(self.mesh, P("chan", None))
            res = self._step(
                x,
                jax.device_put(lo_r, sh_c),
                jax.device_put(lo_i, sh_c),
                jax.device_put(a, NamedSharding(self.mesh, P(None, None))),
                jax.device_put(ang, NamedSharding(self.mesh, P("chan"))),
            )
        from ..pipeline import unpack_results

        buf = np.asarray(res)
        if observer is not None:        # stage counters + overflow warning
            observer(buf)
        return unpack_results(buf)


def channelize_shard(x, lo_r, lo_i, a, ang, p_in: int, period0):
    """Dense-matmul channelize of a shard-local raw plane block inside a
    shard_map body: x (T_raw_local, 2) -> (C_local, T84_local, 2).

    period0 (f32 scalar) is the GLOBAL channelizer-period index of the
    dispatched span's first sample; each time shard adds its own offset
    via axis_index, so the continuous-LO (lo_wrap=False) phase stays
    stream-exact in windowed streaming.  With the reference's wrapped LO
    (ang = 0) the phase term is exactly 1."""
    t_local = x.shape[0]
    b_local = t_local // p_in
    shard = jax.lax.axis_index("time")
    b0 = period0 + (shard * b_local).astype(jnp.float32)
    b_idx = b0 + jnp.arange(b_local, dtype=jnp.float32)
    theta = -ang[:, None] * b_idx[None, :]
    ph_r, ph_i = jnp.cos(theta), jnp.sin(theta)
    xr = x[:, 0].astype(jnp.float32).reshape(b_local, p_in)
    xi = x[:, 1].astype(jnp.float32).reshape(b_local, p_in)
    mr = xr[None] * lo_r[:, None, :] - xi[None] * lo_i[:, None, :]
    mi = xr[None] * lo_i[:, None, :] + xi[None] * lo_r[:, None, :]
    zr = mr * ph_r[:, :, None] - mi * ph_i[:, :, None]
    zi = mr * ph_i[:, :, None] + mi * ph_r[:, :, None]
    yr = jnp.einsum("cbn,nm->cbm", zr, a,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    yi = jnp.einsum("cbn,nm->cbm", zi, a,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    c = yr.shape[0]
    return jnp.stack([yr.reshape(c, -1), yi.reshape(c, -1)], axis=-1)


def raw_decode_step(max_candidates: int, max_symbols: int, max_out: int,
                    p_in: int):
    """shard_map body: shard-local RAW wideband planes -> packed candidate
    rows.  Channelize happens INSIDE the sharded program (period-aligned
    raw input needs no halo; the 84 kHz stream exchanges halos as usual),
    so no host round-trip of decimated samples exists anywhere — the
    multi-chip analogue of the single-chip fused-ingest path."""
    inner = packed_decode_step(max_candidates, max_symbols, max_out)

    def step(x, lo_r, lo_i, a, ang, period0):
        y = channelize_shard(x, lo_r, lo_i, a, ang, p_in, period0)
        return inner(y)

    return step


def packed_decode_step(max_candidates: int, max_symbols: int, max_out: int):
    """shard_map body shared by the single-host and multi-host decoders:
    local (C_local, T_local, 2) decimated block -> packed candidate rows,
    with halo exchange along "time" (NVLink within a host, the host
    network across hosts)
    and global chan/t0 baked into the row meta."""
    right = burst_window(max_symbols)

    def step(y):
        from ..pipeline import _device_decode_packed

        t_local = y.shape[1]
        c_local = y.shape[0]
        y_ext = _halo_exchange(y, HALO_LEFT, right, "time")
        shard = jax.lax.axis_index("time")
        chan_base = jax.lax.axis_index("chan") * c_local
        buf = _device_decode_packed(
            y_ext, max_candidates, max_symbols, max_out,
            chan_base=chan_base,
            core_start=HALO_LEFT, core_len=t_local,
        )
        return globalize_t0(buf, (shard * t_local).astype(jnp.int32))

    return step


@dataclass
class ShardedDecoder:
    """Jitted sharded decode step over a (chan, time) mesh.

    decode(y): y is a global (C, T) array (or host numpy) of decimated
    84 kHz channel streams; C divisible by mesh chan size, T by time size.
    Each shard runs the early-compaction packed decode (one uint8 row per
    surviving candidate, pipeline.pack layout) and the host does a single
    fetch; returns a candidate-dict list with global chan/t0.
    """
    mesh: Mesh
    max_candidates: int = 8
    max_symbols: int = 1024
    max_out: int = 64

    def __post_init__(self):
        self._step = jax.jit(
            jax.shard_map(
                packed_decode_step(
                    self.max_candidates, self.max_symbols, self.max_out
                ),
                mesh=self.mesh,
                in_specs=(P("chan", "time", None),),
                out_specs=P(("chan", "time"), None),
            )
        )

    def decode(self, y, observer=None) -> list:
        from ..pipeline import unpack_results

        with self.mesh:
            y = jax.device_put(
                jnp.asarray(
                    pack_complex(y)
                    if (isinstance(y, np.ndarray) and np.iscomplexobj(y))
                    else y,
                    dtype=jnp.float32,
                ),
                NamedSharding(self.mesh, P("chan", "time", None)),
            )
            res = self._step(y)
        buf = np.asarray(res)
        if observer is not None:        # stage counters + overflow warning
            observer(buf)
        return unpack_results(buf)
