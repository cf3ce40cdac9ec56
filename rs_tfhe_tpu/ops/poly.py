"""Exact negacyclic polynomial arithmetic in Z_{2^32}[X]/(X^N + 1).

Instead of porting the reference's f64 negacyclic FFT (rs-tfhe
fft/klemsa.rs:88-174 and the SPQLIOS AVX/FMA assembly), polynomial products
are computed as *integer-exact int8 matrix multiplications*:

  1. Extend t to t_ext = [t, -t] of length 2N; then the negacyclic product
     (d * t)[n] = sum_m d[m] * t_ext[(n - m) mod 2N], i.e. a matmul of d
     against the "negacyclic circulant" matrix C[m, n] = t_ext[(n-m) mod 2N].
  2. Split both operands into balanced signed 8-bit limbs (torus.py), so each
     limb-level contraction accumulates exactly in int32 (or float32 when
     chunked), with zero rounding error.
  3. Recombine limb products with shifts modulo 2^32.

This is *more* exact than the reference (whose FFT carries +/-1 ulp rounding,
fft/mod.rs:136-159) and keeps the hot loop on the tensor cores instead of
scalar FFT butterflies.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..params import TORUS_BITS
from ..torus import (
    TORUS_DTYPE,
    neg_torus,
    recombine_limb_products,
    split_digit_limbs,
    split_u32_limbs,
)

# ---------------------------------------------------------------------------
# Exact integer dot products
# ---------------------------------------------------------------------------

#: float32 holds integers exactly up to 2^24; limb products are <= 2^14, so a
#: contraction chunk of 1024 keeps every partial sum <= 2^24.
_BF16_CHUNK = 1024


def exact_dot_i8(lhs: jax.Array, rhs: jax.Array, rhs_k_axis: int = 0) -> jax.Array:
    """Integer-exact contraction of int8 operands -> int32.

    lhs [..., K]; rhs [K, M] (rhs_k_axis=0) or [M, K] (rhs_k_axis=1, the
    contraction axis minor on both operands). Returns [..., M].
    With dot_impl="int8" this is a native s8 x s8 -> s32 dot. With "bf16" the
    contraction is chunked so float32 accumulation stays exact.
    """
    dims = (((lhs.ndim - 1,), (rhs_k_axis,)), ((), ()))
    if config.dot_impl == "int8":
        return jax.lax.dot_general(
            lhs, rhs, dims, preferred_element_type=jnp.int32
        )
    k = lhs.shape[-1]
    out = None
    for start in range(0, k, _BF16_CHUNK):
        stop = min(start + _BF16_CHUNK, k)
        part = jax.lax.dot_general(
            lhs[..., start:stop].astype(jnp.bfloat16),
            jax.lax.slice_in_dim(rhs, start, stop, axis=rhs_k_axis).astype(
                jnp.bfloat16
            ),
            dims,
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)
        out = part if out is None else out + part
    return out


# ---------------------------------------------------------------------------
# Negacyclic structure helpers
# ---------------------------------------------------------------------------

def negacyclic_extend(t: jax.Array) -> jax.Array:
    """uint32 [..., N] -> [..., 2N] with the negated second period."""
    return jnp.concatenate([t, neg_torus(t)], axis=-1)


def _roll_block(x: jax.Array, blk: int) -> jax.Array:
    """W[..., mi, c] = x[..., (c - mi) mod 2N] for mi in [0, blk).

    Log-doubling construction: blk rows of the circulant of x built with
    log2(blk) (concat, static-roll) pairs — every op is a static slice or
    concatenation, so XLA fuses the whole build into one elementwise pass.
    """
    w = x[..., None, :]
    k = 1
    while k < blk:
        w = jnp.concatenate([w, jnp.roll(w, k, axis=-1)], axis=-2)
        k *= 2
    return w


def circulant_rows(x: jax.Array, n: int) -> jax.Array:
    """Gather-free circulant: C[..., m, c] = x[..., (c - m) mod 2N].

    x: [..., 2N] -> [..., N, N], built as n/blk row-blocks of a blk-row
    mini-circulant, each block an aligned static slice of its doubling.
    """
    two_n = x.shape[-1]
    assert two_n == 2 * n
    blk = min(128, n)
    assert n % blk == 0
    w = _roll_block(x, blk)  # [..., blk, 2N]
    w2 = jnp.concatenate([w, w], axis=-1)  # [..., blk, 4N]
    parts = [
        jax.lax.slice_in_dim(w2, two_n - blk * u, two_n - blk * u + n, axis=-1)
        for u in range(n // blk)
    ]
    c = jnp.stack(parts, axis=-3)  # [..., n/blk, blk, N]
    return c.reshape(*x.shape[:-1], n, n)


# ---------------------------------------------------------------------------
# Exact negacyclic products
# ---------------------------------------------------------------------------

def polymul_small_by_torus(d: jax.Array, t: jax.Array, d_limbs: int) -> jax.Array:
    """Exact negacyclic product of small-integer polys with torus polys.

    d: int32 [..., J, N]  (|coeff| < 2^(8*d_limbs - 1), e.g. gadget digits)
    t: uint32 [J, N]      (shared across the batch, e.g. TRGSW rows)
    Returns uint32 [..., N] = sum_j d_j * t_j  (negacyclic, mod 2^32).
    """
    rhs = build_step_matrix(t[:, None, :])  # [4*N, J*N]
    return polymul_small_by_torus_multi(d, rhs, d_limbs, 1)[..., 0, :]


def build_step_matrix(t: jax.Array) -> jax.Array:
    """Build the exact-convolution matmul operand for a set of torus polys.

    t: uint32 [J, O, N] (e.g. one bootstrapping-key step: J = 2L gadget rows,
    O = 2 output polys a/b). Returns int8 [O*4*N, J*N]: row (o, q, c),
    column (j, m) holds torus limb q of t_ext[j, o, (c - m) mod 2N], so ONE
    plain 2-D contraction of the [F, J*N] digit rows against it yields every
    (output poly, limb) product at once, with the contraction axis minor on
    both operands (the int8 tensor-core GEMM layout) and no broadcast lhs.

    Rows are the circulant of the index-reversed extension y[k] =
    t_ext[-k mod 2N] (circulant_rows: C[c, m] = y[(m - c) mod 2N]); the
    (J, c) axis swap fuses into the build. The operand is materialised
    behind an optimization barrier: for a single digit row XLA rewrites the
    contraction as multiply + reduce and would otherwise fuse the whole
    slice/concatenate build into that reduction, which the GPU compiler
    takes 40-90 s per step program to emit.
    """
    j, o, n = t.shape
    x = negacyclic_extend(t)  # [J, O, 2N] uint32
    y = jnp.concatenate([x[..., :1], x[..., :0:-1]], axis=-1)  # x[-k mod 2N]
    yl = split_u32_limbs(y).transpose(1, 3, 0, 2)  # [O, 4, J, 2N] int8
    c = circulant_rows(yl, n)  # [O, 4, J, N(c), N(m)]
    mat = c.transpose(0, 1, 3, 2, 4).reshape(o * 4 * n, j * n)
    return jax.lax.optimization_barrier(mat)


def polymul_small_by_torus_multi(
    d: jax.Array, step_matrix: jax.Array, d_limbs: int, num_out: int
) -> jax.Array:
    """out[..., o, n] = sum_j d[..., j, :] (*) t[j, o, :]  (negacyclic, exact).

    d: int32 [..., J, N]; step_matrix: int8 [O*4*N, J*N] from
    build_step_matrix. This is the external-product core (reference
    trgsw.rs:77-116) recast as one 2-D exact integer contraction
    [B*dk, J*N] x [J*N, O*4*N].
    """
    n = d.shape[-1]
    jn = step_matrix.shape[1]
    assert step_matrix.shape[0] == num_out * 4 * n
    batch_shape = d.shape[:-2]
    lhs = split_digit_limbs(d, d_limbs)  # [..., J, N, dk]
    lhs = jnp.moveaxis(lhs, -1, -3).reshape(-1, jn)  # [F = B*dk, J*N]
    out = exact_dot_i8(lhs, step_matrix, rhs_k_axis=1)  # [F, O*4*N] int32
    # Recombine limb products (sum over torus limb q and digit limb p with
    # 2^(8(p+q)) weights, wrapping mod 2^32).
    u = jax.lax.bitcast_convert_type(
        out.reshape(*batch_shape, d_limbs, num_out, 4, n), TORUS_DTYPE
    )
    acc = jnp.zeros((*batch_shape, num_out, n), dtype=TORUS_DTYPE)
    for p in range(d_limbs):
        for q in range(4):
            s = 8 * (p + q)
            if s < TORUS_BITS:
                acc = acc + (u[..., p, :, q, :] << jnp.uint32(s))
    return acc


def polymul_torus_by_binary(a: jax.Array, s: jax.Array) -> jax.Array:
    """Exact negacyclic product a (*) s with binary s (key polynomials).

    a: uint32 [..., N], s: uint32/int [N] with values in {0, 1}.
    Used for TRLWE encryption/decryption (reference trlwe.rs:45, :70).
    """
    n = s.shape[-1]
    # circulant of s as int8 (entries in {-1, 0, 1})
    ext = jnp.concatenate(
        [s.astype(jnp.int8), -s.astype(jnp.int8)], axis=-1
    )  # [2N]
    rhs = circulant_rows(ext, n)  # [N, N] int8; C[m, n'] = +/- s[...]
    lhs = split_u32_limbs(a)  # [..., N, 4]
    lhs = jnp.moveaxis(lhs, -1, -2)  # [..., 4, N]
    out = exact_dot_i8(lhs, rhs)  # [..., 4, N] int32  (|sum| <= N*128 < 2^24)
    # recombine: value[n] = sum_q out[q, n] << 8q; shape to [..., N, 1, 4]
    # (dummy digit-limb axis, torus-limb axis last).
    out = jnp.moveaxis(out, -2, -1)[..., None, :]
    return recombine_limb_products(out)


def negacyclic_static_roll(t: jax.Array, s: int) -> jax.Array:
    """X^s * t for a static s in [0, 2N): two slices + a negation."""
    n = t.shape[-1]
    s = s % (2 * n)
    neg = s >= n
    s = s % n
    lo, hi = t[..., : n - s], t[..., n - s :]
    rolled = jnp.concatenate([neg_torus(hi), lo], axis=-1) if s else t
    return neg_torus(rolled) if neg else rolled


def monomial_rotate(t: jax.Array, k: jax.Array) -> jax.Array:
    """Multiply polynomials by X^k in Z[X]/(X^N+1): out[n] = t_ext[(n-k) mod 2N].

    t: uint32 [..., N]; k: integer array broadcastable to t.shape[:-1]
    (values taken mod 2N). Reference: trgsw.rs:307-330 (exact negation used
    here instead of the reference's MAX-x; see torus.neg_torus).

    Lowered as a log2(2N)-stage barrel rotator: stage i applies the static
    negacyclic roll X^(2^i) under a per-batch select on bit i of k. Every
    stage is aligned slices + an elementwise select — no gathers (a batched
    row-gather here ran at ~3.6 GB/s and dominated the whole bootstrap).
    """
    n = t.shape[-1]
    k_b = jnp.broadcast_to(jnp.asarray(k, dtype=jnp.int32), t.shape[:-1])
    k_b = jnp.mod(k_b, 2 * n)[..., None]  # [..., 1]
    out = t
    for i in range(int(np.log2(2 * n))):
        bit = (k_b >> i) & 1
        out = jnp.where(bit == 1, negacyclic_static_roll(out, 1 << i), out)
    return out


# ---------------------------------------------------------------------------
# Reference oracle (host-side, for tests): schoolbook negacyclic product
# ---------------------------------------------------------------------------

def schoolbook_negacyclic(a, b) -> np.ndarray:
    """Exact negacyclic product of two uint32 polynomials, mod 2^32.

    Quadratic host-side oracle mirroring the reference's cross-check
    (fft/mod.rs:240-255) but in exact integer arithmetic.
    """
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    n = a.shape[-1]
    # wrapping uint32 products, vectorized: out[k] = sum_{i+j=k} a_i b_j with a
    # sign flip on the wrapped half. Build the negacyclic circulant of b.
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    j = (k - i) % (2 * n)
    b_ext = np.concatenate([b, (np.uint32(0) - b)])
    circ = b_ext[j]  # [i, k]
    with np.errstate(over="ignore"):
        prods = a[:, None] * circ  # uint32 wrapping
        return np.add.reduce(prods, axis=0, dtype=np.uint32)
