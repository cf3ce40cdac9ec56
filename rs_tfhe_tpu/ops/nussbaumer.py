"""Nussbaumer negacyclic convolution for the external product — the
small-batch/latency path.

The direct circulant method (ops/poly.py) is throughput-optimal but its
per-step operand build is batch-independent (~50 MB at SECURITY_128_BIT), so
single-gate latency is build-bound. Nussbaumer's algorithm maps the size-N
negacyclic convolution over Z/2^32 onto 2r pointwise size-m negacyclic
convolutions (N = m*r) via DFTs whose twiddles are powers of Y — pure
negacyclic shifts, exact over the integers:

  A[q*r + i] -> a_i(Y) = sum_q A[..] Y^q   in S = Z[Y]/(Y^m + 1)
  A_hat[t]   = sum_i a_i * Y^(w*i*t),  w = m/r,  t < 2r     (shift-adds)
  C_hat[t]   = sum_j A_hat[t, j] (*)_m B_hat[t, j]          (s16 dots)
  16c        = IDFT (unnormalized, wrapping int32)           (shift-adds)
  c          = fold (c_k = lin_k + Y lin_{k+r}) >> log2(2r)  (exact)

Exactness without modular division: the true value 2r*c fits int32
(|c| <= 2L*N*d_max*128 per int8 torus limb), so wrapping intermediate
int32 arithmetic is harmless and the final arithmetic right-shift is exact
— the division-by-transform-length obstruction of power-of-two NTTs over
Z/2^32 never arises. Validated against the schoolbook oracle.

Reference semantics: external product accumulate, rs-tfhe trgsw.rs:77-116.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from ..params import TORUS_BITS, TfheParams
from ..torus import TORUS_DTYPE, split_u32_limbs
from .poly import negacyclic_extend, circulant_rows, negacyclic_static_roll

#: transform radix: r X-coefficients -> 2r DFT points; m = N / r.
R = 8


def _shift(v: jax.Array, s: int, m: int) -> jax.Array:
    """v * Y^s in Z[Y]/(Y^m + 1) along the last axis (static s)."""
    return negacyclic_static_roll(v, s % (2 * m), )


def _fwd(a: jax.Array, m: int, r: int) -> jax.Array:
    """[..., r, m] -> [..., 2r, m]: A_hat[t] = sum_i a_i Y^(w i t)."""
    w = m // r
    outs = []
    for t in range(2 * r):
        acc = a[..., 0, :]
        for i in range(1, r):
            acc = acc + _shift(a[..., i, :], w * i * t, m)
        outs.append(acc)
    return jnp.stack(outs, axis=-2)


def _inv_fold_div(ch: jax.Array, m: int, r: int) -> jax.Array:
    """[..., 2r, m] int32 -> [..., r, m]: unnormalized IDFT, fold, >>log2(2r).

    Wrapping int32 throughout; exact because |2r * result| < 2^31.
    """
    w = m // r
    lin = []
    for i in range(2 * r):
        acc = ch[..., 0, :]
        for t in range(1, 2 * r):
            acc = acc + _shift(ch[..., t, :], (-w * i * t) % (2 * m), m)
        lin.append(acc)
    shift_bits = (2 * r).bit_length() - 1
    cols = []
    for k in range(r):
        c16 = lin[k] + _shift(lin[k + r], 1, m)
        cols.append(jax.lax.shift_right_arithmetic(c16, jnp.int32(shift_bits)))
    return jnp.stack(cols, axis=-2)  # [..., r(k), m]


def check_bounds(params: TfheParams) -> bool:
    """Exactness conditions: raw digits must fit the int16 transform
    (half_bg * r < 2^15, i.e. bgbit <= 12 with r = 8 — all boolean sets
    qualify) and 2r * |conv per int8 limb| must fit int32 for the exact
    division."""
    g = params.trgsw_lv1
    if g.half_bg * R >= (1 << 15):
        return False
    bound = 2 * R * 2 * g.l * params.n1 * g.half_bg * 128
    return bound < (1 << 31) and params.n1 % R == 0 and (params.n1 // R) >= R


def prepare_bsk_step(bsk_i: jax.Array, params: TfheParams) -> jax.Array:
    """One BSK step [2L, 2, N] uint32 -> pointwise operand
    int16 [2r, 2L*m, O*4*m]: per DFT point t, the stacked circulant-m
    matrices of the transformed int8 torus limbs."""
    g = params.trgsw_lv1
    n, r = params.n1, R
    m = n // r
    j2 = 2 * g.l
    bl = split_u32_limbs(bsk_i)  # [2L, 2, N, 4] int8
    bl = bl.reshape(j2, 2, m, r, 4).astype(jnp.int16)
    bl = jnp.transpose(bl, (0, 1, 4, 3, 2))  # [2L, 2, 4, r(i), m(Y)]
    bh = _fwd(bl, m, r)  # [2L, 2, 4, 2r, m]  |values| <= r*128
    circ = circulant_rows(negacyclic_extend(bh), m)  # [2L, 2, 4, 2r, m, m]
    # -> [2r(t), 2L(j)*m(u rows), 2(o)*4(q)*m(cols)]
    circ = jnp.transpose(circ, (3, 0, 4, 1, 2, 5))
    return circ.reshape(2 * r, j2 * m, 2 * 4 * m)


def external_product_step(
    digits: jax.Array, bop: jax.Array, params: TfheParams
) -> jax.Array:
    """digits int32 [B, 2L, N]; bop from prepare_bsk_step.
    Returns delta uint32 [B, 2, N] = sum_j digits_j (*) bsk_j, mod 2^32."""
    g = params.trgsw_lv1
    n, r = params.n1, R
    m = n // r
    j2 = 2 * g.l
    batch = digits.shape[0]

    a = digits.reshape(batch, j2, m, r).astype(jnp.int16)
    a = jnp.swapaxes(a, -1, -2)  # [B, 2L, r(i), m(Y)]
    ah = _fwd(a, m, r)  # [B, 2L, 2r, m]  |values| <= r*d_max
    lhs = jnp.transpose(ah, (0, 2, 1, 3)).reshape(batch, 2 * r, j2 * m)

    # per-DFT-point s16 contraction, j-summed: [B, 2r, O*4*m] int32 wrapping
    ch = jax.lax.dot_general(
        jnp.swapaxes(lhs, 0, 1),  # [2r, B, 2L*m]
        bop,  # [2r, 2L*m, O*4*m]
        (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )  # [2r, B, O*4*m]
    ch = jnp.swapaxes(ch, 0, 1).reshape(batch, 2 * r, 2, 4, m)
    ch = jnp.transpose(ch, (0, 2, 3, 1, 4))  # [B, O, 4, 2r, m]

    c = _inv_fold_div(ch, m, r)  # [B, O, 4, r(k), m(Y)] exact conv per limb
    c = jnp.swapaxes(c, -1, -2).reshape(batch, 2, 4, n)  # n = q*r + k order

    u = jax.lax.bitcast_convert_type(c, TORUS_DTYPE)
    acc = jnp.zeros((batch, 2, n), dtype=TORUS_DTYPE)
    for q in range(4):
        s = 8 * q
        if s < TORUS_BITS:
            acc = acc + (u[:, :, q, :] << jnp.uint32(s))
    return acc
