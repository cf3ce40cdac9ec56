"""Discretized-torus arithmetic helpers.

The torus T = R/Z is discretized to 32 bits and stored as `uint32`
(reference: rs-tfhe params.rs:40, utils.rs:9-16). All *server-side* arithmetic
is integer-exact uint32/int32 (no floats); floats appear only in client-side
noise sampling, where only the distribution (not the bits) must match the
reference.

The exact-integer polynomial pipeline relies on *balanced signed 8-bit limb
splitting*: any uint32 t satisfies

    t = l0 + l1*2^8 + l2*2^16 + l3*2^24  (mod 2^32),  |l_p| <= 128,

with l0..l2 in [-128,127] and only the top limb possibly +128 (whose int8
wraparound to -128 is harmless modulo 2^32 because 256*2^24 = 2^32). Products
of two such limbs are <= 2^14, so contractions of length <= 2^17 accumulate
exactly in int32 (and <= 2^10 exactly in float32) — this is what lets int8 matmuls
compute negacyclic convolutions with zero rounding error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .params import TORUS_BITS

TORUS_DTYPE = jnp.uint32
_TWO32 = float(1 << TORUS_BITS)


# ---------------------------------------------------------------------------
# Host-side (client) conversions — exact f64 semantics of the reference
# ---------------------------------------------------------------------------

def f64_to_torus(d) -> np.ndarray:
    """Exact equivalent of rs-tfhe utils.rs:9-12.

    `((d % 1.0) * 2^32) as i64 as u32` — Rust `%` keeps the dividend's sign and
    the i64 cast truncates toward zero.
    """
    d = np.asarray(d, dtype=np.float64)
    frac = np.fmod(d, 1.0)
    return np.trunc(frac * _TWO32).astype(np.int64).astype(np.uint32)


def torus_to_f64(t) -> np.ndarray:
    """Reference: utils.rs:14-16."""
    return np.asarray(t, dtype=np.uint32).astype(np.float64) / _TWO32


# ---------------------------------------------------------------------------
# Device-side noise sampling (distribution-equivalent to utils.rs:22-48)
# ---------------------------------------------------------------------------

def gaussian_torus(key: jax.Array, alpha: float, shape) -> jax.Array:
    """Sample torus noise ~ round-toward-zero(N(0, alpha) * 2^32) as uint32.

    Matches the reference's gaussian_f64 (utils.rs:31-38) in distribution.
    Computed in float32: alpha*2^32 is at most ~10^5 for all parameter sets, so
    float32 resolution (~2^-24 relative) only perturbs the noise by a
    sub-ulp amount, far below the noise scale itself.
    """
    x = jax.random.normal(key, shape, dtype=jnp.float32) * jnp.float32(alpha * _TWO32)
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), TORUS_DTYPE)


def uniform_torus(key: jax.Array, shape) -> jax.Array:
    """Uniform uint32 mask coefficients (reference: rng.gen::<u32>())."""
    return jax.random.bits(key, shape, dtype=jnp.uint32)


_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32_bits(key: jax.Array, start, count: int) -> jax.Array:
    """uint32 random bits for flat counter range [start, start+count).

    Bit-identical to ``jax.random.bits(key, shape, uint32).ravel()[start:
    start+count]`` under JAX's default partitionable threefry PRNG, whose
    per-element 64-bit counter is just the flat index (hi word 0 for sizes
    < 2^32) and whose output is ``o1 ^ o2`` of the Threefry-2x32 block
    (Salmon et al., Random123; jax._src.prng._threefry_random_bits_
    partitionable). Verified against jax.random.bits in tests/test_tlwe.py.

    Exists so key generation can produce huge uniform masks inside a
    lax.scan chunk by chunk: the chunked scan keeps each fusion small (a
    monolithic random.bits fusion at KSK shapes [36864, 700] compiled
    slowly on the accelerator this library was first written for) and
    produces the very same bits. `start` may be a traced scalar (scan
    carry); the caller must keep the total size below 2^32.
    """
    kd = jax.random.key_data(key)
    return threefry2x32_bits_raw(kd[0], kd[1], start, count)


def threefry2x32_bits_raw(k1, k2, start, count: int) -> jax.Array:
    """`threefry2x32_bits` from the raw 2-word key data (uint32 k1, k2).

    Exists so SEEDED ciphertexts can ship just (k1, k2) and have any
    runtime — this module, or the native C++ client (csrc threefry_bits)
    — re-derive the identical mask stream."""
    ks = (k1, k2, k1 ^ k2 ^ jnp.uint32(0x1BD11BDA))
    x1 = jnp.broadcast_to(ks[0], (count,))
    x2 = jnp.uint32(start) + jax.lax.iota(jnp.uint32, count) + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x1 = x1 + x2
            x2 = (x2 << jnp.uint32(r)) | (x2 >> jnp.uint32(32 - r))
            x2 = x2 ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x1 ^ x2


# ---------------------------------------------------------------------------
# Balanced signed 8-bit limb splitting (device-side, integer-exact)
# ---------------------------------------------------------------------------

def _balanced_limbs_i32(x: jax.Array, num_limbs: int) -> jax.Array:
    """Split int32 values into `num_limbs` balanced base-256 limbs.

    Returns int32 [..., num_limbs] with limbs in [-128, 127] except possibly
    the last (residual) limb. x must be int32.
    """
    limbs = []
    cur = x
    for _ in range(num_limbs - 1):
        r = jnp.bitwise_and(cur, 255)
        carry = (r >= 128).astype(jnp.int32)
        limbs.append(r - 256 * carry)
        # (cur - limb) / 256 == arithmetic_shift(cur, 8) + carry, never overflows
        cur = jnp.right_shift(cur, 8) + carry
    limbs.append(cur)
    return jnp.stack(limbs, axis=-1)


def split_u32_limbs(x: jax.Array) -> jax.Array:
    """uint32 [...] -> int8 [..., 4] balanced limbs, exact modulo 2^32.

    The top limb may be +128 before the int8 cast; its modular wrap to -128
    changes the value by 256*2^24 = 2^32 ≡ 0, so recombination mod 2^32 is
    unaffected.
    """
    t = jax.lax.bitcast_convert_type(x, jnp.int32)
    return _balanced_limbs_i32(t, 4).astype(jnp.int8)


def split_u32_limbs_planar(x: jax.Array) -> jax.Array:
    """uint32 [..., W] -> int8 [..., 4, W] balanced limbs, PLANAR layout.

    Same limbs as split_u32_limbs but stacked on a new MAJOR axis (limb
    planes) instead of interleaved into the minor axis: four independent
    elementwise planes, where the interleaving reshape [..., W, 4] ->
    [..., 4W] is a minor-axis relayout of the whole key table.
    Consumers contract the flattened [..., 4W] table and recombine with
    recombine_planar.
    """
    t = jax.lax.bitcast_convert_type(x, jnp.int32)
    limbs = []
    cur = t
    for _ in range(3):
        r = jnp.bitwise_and(cur, 255)
        carry = (r >= 128).astype(jnp.int32)
        limbs.append(r - 256 * carry)
        cur = jnp.right_shift(cur, 8) + carry
    limbs.append(cur)
    return jnp.stack(limbs, axis=-2).astype(jnp.int8)  # [..., 4, W]


def recombine_planar(acc: jax.Array) -> jax.Array:
    """int32 [..., 4, W] planar limb sums -> uint32 [..., W] mod 2^32.

    acc[..., q, :] is an exact integer combination of limb-q planes
    (split_u32_limbs_planar); the result is sum_q acc_q * 2^(8q) with
    int32 values bitcast to uint32 (two's complement keeps the modular
    arithmetic exact).
    """
    cu = jax.lax.bitcast_convert_type(acc, TORUS_DTYPE)
    out = cu[..., 0, :]
    for q in range(1, 4):
        out = out + (cu[..., q, :] << jnp.uint32(8 * q))
    return out


def lane_pad(n: int, lanes: int = 128) -> int:
    """Round n up to a multiple of `lanes` (the planar KSK table's column
    padding; a layout constant, not yet re-derived for the GPU)."""
    return -(-n // lanes) * lanes


def planar_limb_table(rows: jax.Array, row_chunk: int = 1024) -> jax.Array:
    """uint32 [R, W] rows -> int8 [R, 4*lane_pad(W)] planar-padded limbs.

    Chunked over rows with lax.scan so the limb planes never form one
    giant fusion (see lwe_encrypt_rows_limbs).
    Same layout contract as that function's output.
    """
    r, w = rows.shape
    p = lane_pad(w)
    cs = next(c for c in range(min(row_chunk, r), 0, -1) if r % c == 0)

    def step(_, chunk):
        padded = jnp.pad(chunk, ((0, 0), (0, p - w)))
        return None, split_u32_limbs_planar(padded).reshape(cs, 4 * p)

    _, limbs = jax.lax.scan(step, None, rows.reshape(r // cs, cs, w))
    return limbs.reshape(r, 4 * p)


def split_digit_limbs(d: jax.Array, num_limbs: int) -> jax.Array:
    """Gadget digits int32 [...] (|d| <= 2^(bgbit-1)) -> int8 [..., num_limbs]."""
    if num_limbs == 1:
        return d.astype(jnp.int8)[..., None]
    return _balanced_limbs_i32(d, num_limbs).astype(jnp.int8)


def recombine_limb_products(conv: jax.Array) -> jax.Array:
    """Recombine exact limb-convolution results modulo 2^32.

    conv: int32 [..., dk, 4] where conv[..., p, q] is the integer convolution of
    digit-limb p with torus-limb q. Returns uint32 [...]:
        sum_{p,q} conv[p,q] * 2^(8(p+q))  (mod 2^32).
    Terms with 8(p+q) >= 32 vanish modulo 2^32 and are skipped.
    """
    dk = conv.shape[-2]
    out = jnp.zeros(conv.shape[:-2], dtype=TORUS_DTYPE)
    cu = jax.lax.bitcast_convert_type(conv, TORUS_DTYPE)
    for p in range(dk):
        for q in range(4):
            s = 8 * (p + q)
            if s >= TORUS_BITS:
                continue
            out = out + (cu[..., p, q] << jnp.uint32(s))
    return out


def neg_torus(x: jax.Array) -> jax.Array:
    """Exact torus negation -x mod 2^32.

    Note: the reference uses `Torus::MAX - x` (= -x-1) in its monomial-rotation
    and sample-extraction wrap paths (trgsw.rs:317-326, trlwe.rs:114); that is
    an off-by-one from true negation whose effect is absorbed by noise. We use
    exact negation — the mathematically correct choice.
    """
    return jnp.zeros_like(x) - x
