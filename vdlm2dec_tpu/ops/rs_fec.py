"""Vectorised RS(255,249) decoder: GF(2^8) as mod-2 matmuls.

The expensive, regular parts of RS decoding — syndrome computation, Chien
search and the Forney numerator/denominator evaluations — are F2-linear maps
from the input bits, so each becomes ONE dense f32 matmul followed by &1
(exact: accumulators stay far below 2^24).  Only the tiny Berlekamp-Massey
recursion (6 fixed steps, rs.c:144-196) runs as elementwise log/antilog
gathers over the row batch.

Semantics pinned against rs.c:81-291 + the erasure patterns of
vdlm2.c:64-82; oracle comparison in tests.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import GF_A0, GF_EXP, GF_LOG, RS_FCR, RS_N, RS_ROOTS

_EXPN = GF_EXP.astype(np.int32)     # exp table, [255] = 0
_LOGN = GF_LOG.astype(np.int32)     # log table, log(0) = 255 (A0)


def _gfmul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = _EXPN[(_LOGN[a] + _LOGN[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out)


def _bits_of(v: np.ndarray) -> np.ndarray:
    """(...,) bytes -> (..., 8) bits, LSB first."""
    return (v[..., None] >> np.arange(8)) & 1


@functools.lru_cache(maxsize=1)
def _matrices() -> dict[str, np.ndarray]:
    q1 = np.arange(1, RS_N + 1)                       # root exponents i=1..255
    out: dict[str, np.ndarray] = {}

    # SYN: (2040, 48)  data bit (j, a) -> syndrome bit (i, b)
    j = np.arange(RS_N)
    exps = ((RS_FCR + np.arange(RS_ROOTS))[:, None] * (RS_N - 1 - j)[None, :]) % 255
    alpha = _EXPN[exps]                                # (6, 255)
    syn = np.zeros((RS_N * 8, RS_ROOTS * 8), dtype=np.float32)
    for a in range(8):
        val = _gfmul_np(np.full_like(alpha, 1 << a), alpha)   # (6, 255)
        bits = _bits_of(val)                                   # (6, 255, 8)
        syn[a::8, :] = bits.transpose(1, 0, 2).reshape(RS_N, 48)
    out["syn"] = syn

    def eval_matrix(degrees: list[int],
                    pos_factor: np.ndarray | None = None) -> np.ndarray:
        """coef bit (d_idx, a) -> value bit (q, b) for sum_d c_d alpha^{d*i};
        pos_factor (255,) GF values additionally multiply column q —
        folding a per-position constant into the bit-linear map costs
        nothing at runtime."""
        m = np.zeros((len(degrees) * 8, RS_N * 8), dtype=np.float32)
        for di, d in enumerate(degrees):
            alpha_d = _EXPN[(d * q1) % 255]            # (255,)
            if pos_factor is not None:
                alpha_d = _gfmul_np(alpha_d, pos_factor)
            for a in range(8):
                val = _gfmul_np(np.full_like(alpha_d, 1 << a), alpha_d)
                m[di * 8 + a, :] = _bits_of(val).reshape(-1)
        return m

    out["chien"] = eval_matrix([1, 2, 3, 4, 5, 6])     # lambda_1..6
    num2 = _EXPN[((q1 * (RS_FCR - 1)) + RS_N) % 255].astype(np.int32)
    # omega eval with the Forney num2 = alpha^{q(FCR-1)+N} constant folded
    # into the matrix: num12(q) = omega(alpha^..., q) * num2(q) comes out
    # of the SAME matmul that used to produce num1 alone
    out["omega12"] = eval_matrix([0, 1, 2, 3, 4, 5], pos_factor=num2)
    out["den"] = eval_matrix([0, 2, 4])                # lambda_1,3,5 at even i

    # GF(2^8) inverse table with inv[0] = 0: the bilinear product then
    # yields 0 wherever den == 0 or num == 0, matching the old where()
    inv = np.zeros(256, dtype=np.int32)
    inv[1:] = _EXPN[(255 - _LOGN[np.arange(1, 256)]) % 255]
    out["inv"] = inv

    # bilinear GF multiply reduction: bit i of a times bit j of b lands on
    # the bits of alpha^{i+j} (mod the field polynomial)
    red = np.zeros((64, 8), dtype=np.float32)
    for i in range(8):
        for j in range(8):
            red[i * 8 + j, :] = _bits_of(
                _gfmul_np(np.array(1 << i), np.array(1 << j))).reshape(-1)
    out["bilin"] = red

    # erasure-locator init per class: 0 none, 1 = {253,254}, 2 = {251..254}
    lam_init = np.zeros((3, RS_ROOTS + 1), dtype=np.int32)
    lam_init[:, 0] = 1
    for cls, eras in enumerate([[], [253, 254], [251, 252, 253, 254]]):
        lam = np.zeros(RS_ROOTS + 1, dtype=np.int64)
        lam[0] = 1
        if eras:
            lam[1] = _EXPN[(RS_N - 1 - eras[0]) % 255]
            for i in range(1, len(eras)):
                u = (RS_N - 1 - eras[i]) % 255
                for jj in range(i + 1, 0, -1):
                    t = _LOGN[lam[jj - 1]]
                    if t != GF_A0:
                        lam[jj] ^= _EXPN[(u + t) % 255]
        lam_init[cls] = lam
    out["lam_init"] = lam_init
    out["n_eras"] = np.array([0, 2, 4], dtype=np.int32)
    return out


@functools.lru_cache(maxsize=1)
def _mul_table() -> np.ndarray:
    """(256*256,) GF(2^8) product LUT: one gather replaces two log gathers,
    an add, a mod and a zero-select in the BM/omega inner loops."""
    a = np.arange(256)
    t = _EXPN[(_LOGN[a][:, None] + _LOGN[a][None, :]) % 255]
    t[0, :] = 0
    t[:, 0] = 0
    return t.reshape(-1).astype(np.int32)


def _mod2_matmul(bits: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    # DEFAULT allows TF32: exact here, 0/1 operands and sums < 2^11
    acc = jnp.dot(bits.astype(jnp.float32), m, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.DEFAULT)
    return acc.astype(jnp.int32) & 1


def _pack_bytes(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., K*8) bits -> (..., K) bytes LSB-first."""
    shp = bits.shape[:-1] + (bits.shape[-1] // 8, 8)
    w = (1 << jnp.arange(8, dtype=jnp.int32))
    return jnp.sum(bits.reshape(shp) * w, axis=-1)


def _gfmul(a: jnp.ndarray, b: jnp.ndarray, exp, log) -> jnp.ndarray:
    out = exp[(log[a] + log[b]) % 255]
    return jnp.where((a == 0) | (b == 0), 0, out)


def _gfmul_lut(a: jnp.ndarray, b: jnp.ndarray, mul) -> jnp.ndarray:
    return mul[a * 256 + b]


def _lut_lookup_onehot(x: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """256-entry LUT lookup as a one-hot matmul in place of a large
    dynamic gather; bf16 is exact here (LUT values <= 255 < 2^8
    mantissa)."""
    oh = (x[..., None] == jnp.arange(256, dtype=x.dtype)).astype(
        jnp.bfloat16)
    v = jnp.dot(oh.reshape(-1, 256), lut.astype(jnp.bfloat16)[:, None],
                preferred_element_type=jnp.float32)
    return v.reshape(x.shape).astype(jnp.int32)


def _gfmul_bilinear(a: jnp.ndarray, b: jnp.ndarray,
                    red: jnp.ndarray) -> jnp.ndarray:
    """GF(2^8) product of two same-shape byte tensors WITHOUT table
    gathers: outer product of the operand bits, reduced by the constant
    (64, 8) alpha^{i+j} bit matrix, mod-2."""
    ab = ((a[..., None] >> jnp.arange(8)) & 1)
    bb = ((b[..., None] >> jnp.arange(8)) & 1)
    o = (ab[..., :, None] * bb[..., None, :]).reshape(a.shape + (64,))
    # DEFAULT allows TF32: exact here, 0/1 operands and sums <= 64
    acc = jnp.dot(o.reshape(-1, 64).astype(jnp.float32), red,
                  preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.DEFAULT)
    cb = acc.astype(jnp.int32) & 1
    return _pack_bytes(cb.reshape(a.shape + (8,)).reshape(
        a.shape[:-1] + (a.shape[-1] * 8,)))


@functools.partial(jax.jit)
def rs_decode_rows(rows: jnp.ndarray, eras_class: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decode a batch of RS rows.

    rows: (M, 255) uint8; eras_class: (M,) int32 in {0,1,2} (see _matrices).
    Returns (corrected rows (M, 255) uint8, count (M,) int32) with count as
    rs() returns it: 0 clean, n corrections, -1 uncorrectable (row returned
    unmodified).
    """
    mats = _matrices()
    exp = jnp.asarray(_EXPN)
    log = jnp.asarray(_LOGN)
    mul = jnp.asarray(_mul_table())
    m = rows.shape[0]
    data = rows.astype(jnp.int32)

    # ---- syndromes (one matmul) ----
    dbits = ((data[:, :, None] >> jnp.arange(8)) & 1).reshape(m, RS_N * 8)
    sbits = _mod2_matmul(dbits, jnp.asarray(mats["syn"]))
    s = _pack_bytes(sbits)                              # (M, 6)
    syn_zero = jnp.all(s == 0, axis=1)

    # ---- Berlekamp-Massey, erasure-initialised, 6 static steps ----
    lam = jnp.asarray(mats["lam_init"])[eras_class]     # (M, 7) GF values
    no_eras = jnp.asarray(mats["n_eras"])[eras_class]   # (M,)
    b = log[lam]                                        # (M, 7) log form
    el = no_eras

    for r in range(1, RS_ROOTS + 1):
        active = r > no_eras
        # discrepancy: XOR_{i<r} lam[i] * s[r-1-i]
        discr = jnp.zeros((m,), dtype=jnp.int32)
        for i in range(r):
            discr = discr ^ _gfmul_lut(lam[:, i], s[:, r - 1 - i], mul)
        dlog = log[discr]
        dz = discr == 0

        b_shift = jnp.concatenate(
            [jnp.full((m, 1), GF_A0, dtype=b.dtype), b[:, :-1]], axis=1
        )
        # t = lambda - discr * x * b
        bx = jnp.where(
            b[:, :-1] != GF_A0,
            exp[(dlog[:, None] + b[:, :-1]) % 255],
            0,
        )
        t = jnp.concatenate([lam[:, :1], lam[:, 1:] ^ bx], axis=1)
        upd = 2 * el <= (r + no_eras - 1)
        el_new = jnp.where(upd, r + no_eras - el, el)
        b_upd = jnp.where(
            lam != 0, (log[lam] - dlog[:, None] + 255) % 255, GF_A0
        )
        b_nz = jnp.where(upd[:, None], b_upd, b_shift)
        lam_new = jnp.where(dz[:, None], lam, t)
        b_new = jnp.where(dz[:, None], b_shift, b_nz)
        lam = jnp.where(active[:, None], lam_new, lam)
        b = jnp.where(active[:, None], b_new, b)
        el = jnp.where(active & ~dz, el_new, el)

    idx7 = jnp.arange(RS_ROOTS + 1)
    deg_lambda = jnp.max(jnp.where(lam != 0, idx7[None, :], 0), axis=1)

    # ---- Chien search (one matmul): val(q) = 1 ^ sum_j lam_j a^{j(q+1)} --
    lbits = ((lam[:, 1:, None] >> jnp.arange(8)) & 1).reshape(m, 48)
    cbits = _mod2_matmul(lbits, jnp.asarray(mats["chien"]))
    val = _pack_bytes(cbits) ^ 1                        # (M, 255)
    root_mask = val == 0
    n_roots = jnp.sum(root_mask, axis=1)

    # ---- omega = s * lambda mod x^6 (tiny, log/antilog) ----
    omega = []
    for i in range(RS_ROOTS):
        acc = jnp.zeros((m,), dtype=jnp.int32)
        for jj in range(i + 1):
            acc = acc ^ _gfmul_lut(s[:, i - jj], lam[:, jj], mul)
        omega.append(acc)
    omega = jnp.stack(omega, axis=1)                    # (M, 6)

    # ---- Forney over all positions (two matmuls) ----
    # num12 = omega(alpha^{-q}) * num2(q) in ONE matmul (num2 folded into
    # the eval matrix); magnitude = num12 * inv(den) via a one-hot
    # inverse lookup + a bilinear bit product, in place of three (M, 255)
    # log/exp gathers; inv[0] = 0 makes the product vanish exactly where
    # num==0 or den==0.
    obits = ((omega[:, :, None] >> jnp.arange(8)) & 1).reshape(m, 48)
    num12 = _pack_bytes(_mod2_matmul(obits, jnp.asarray(mats["omega12"])))
    lodd = lam[:, 1::2]                                 # lambda_1,3,5
    dbits2 = ((lodd[:, :, None] >> jnp.arange(8)) & 1).reshape(m, 24)
    den = _pack_bytes(_mod2_matmul(dbits2, jnp.asarray(mats["den"])))
    inv_den = _lut_lookup_onehot(den, jnp.asarray(mats["inv"]))
    mag = _gfmul_bilinear(num12, inv_den, jnp.asarray(mats["bilin"]))

    # Forney failure semantics (rs.c:257-283): the reference walks roots from
    # the highest position down and bails at the first den==0, so corrections
    # at positions *above* the failing one have already been applied to data.
    bad = root_mask & (den == 0)
    bad_den = jnp.any(bad, axis=1)
    pos_idx = jnp.arange(RS_N, dtype=jnp.int32)[None, :]
    bad_threshold = jnp.max(jnp.where(bad, pos_idx, -1), axis=1)   # -1: none
    deg_ok = (~syn_zero) & (n_roots == deg_lambda)
    apply_mask = (
        root_mask
        & deg_ok[:, None]
        & (pos_idx > bad_threshold[:, None])
    )
    corr = jnp.where(apply_mask, mag, 0)
    fixed = (data ^ corr).astype(jnp.uint8)

    count = jnp.where(
        syn_zero,
        0,
        jnp.where((n_roots == deg_lambda) & ~bad_den, n_roots, -1),
    ).astype(jnp.int32)
    return fixed, count
