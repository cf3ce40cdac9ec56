"""(T)LWE ciphertexts over the discretized torus, batch-first.

A batch of LWE ciphertexts is a uint32 array [..., n+1]: the first n columns
are the mask `a`, the last column the body `b` (reference tlwe.rs:11-14).
The same functions serve lv0 (n = n0) and lv1 (n = N) by passing the matching
secret-key vector. All homomorphic operators are plain wrapping uint32
arithmetic on whole batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .torus import (
    TORUS_DTYPE,
    f64_to_torus,
    gaussian_torus,
    lane_pad,
    neg_torus,
    split_u32_limbs_planar,
    threefry2x32_bits,
    threefry2x32_bits_raw,
    uniform_torus,
)


def lwe_encrypt_torus(
    key: jax.Array, s: jax.Array, mu: jax.Array, alpha: float
) -> jax.Array:
    """Encrypt torus messages under binary secret s.

    key: jax PRNG key; s: uint32 [n] in {0,1}; mu: uint32 [...]; returns
    uint32 [..., n+1]. Reference: tlwe.rs:37-53 (b = mu + noise + <a, s>).
    """
    n = s.shape[0]
    k_mask, k_noise = jax.random.split(key)
    a = uniform_torus(k_mask, (*mu.shape, n))
    noise = gaussian_torus(k_noise, alpha, mu.shape)
    b = mu + noise + jnp.sum(a * s, axis=-1, dtype=TORUS_DTYPE)
    return jnp.concatenate([a, b[..., None]], axis=-1)


def lwe_encrypt_torus_seeded(
    key: jax.Array, s: jax.Array, mu: jax.Array, alpha: float
) -> tuple[jax.Array, jax.Array]:
    """Seeded (compressed) LWE encryption: ship 1 word per ciphertext.

    The mask rows are not stored — row r is the counter-exact threefry
    stream threefry2x32_bits(seed, r*n, n) — so the wire format is just
    (seed: uint32 [2], bodies: uint32 [B]): an (n+1)x transport/storage
    compression (701x at the 128-bit sets). Any runtime re-derives the
    identical masks: `lwe_expand_seeded` here, `lwe_expand_seeded` /
    `lwe_decrypt_bool_seeded` in the native C++ client (csrc). The
    expanded ciphertext is exactly an `lwe_encrypt_torus` sample whose
    mask came from the threefry stream, so security is unchanged
    (uniform mask, fresh gaussian noise); the seed must be used for ONE
    batch only, like any nonce. No reference analogue (rs-tfhe always
    ships full masks).

    mu: uint32 [B]. Returns (seed uint32 [2], bodies uint32 [B]).
    """
    n = s.shape[0]
    (batch,) = mu.shape
    k_mask, k_noise = jax.random.split(key)
    seed = jax.random.key_data(k_mask).astype(jnp.uint32)
    a = threefry2x32_bits(k_mask, 0, batch * n).reshape(batch, n)
    noise = gaussian_torus(k_noise, alpha, mu.shape)
    b = mu + noise + jnp.sum(a * s, axis=-1, dtype=TORUS_DTYPE)
    return seed, b


def lwe_expand_seeded(seed: jax.Array, bodies: jax.Array, n: int) -> jax.Array:
    """(seed uint32 [2], bodies uint32 [B]) -> full LWE batch [B, n+1]."""
    (batch,) = bodies.shape
    a = threefry2x32_bits_raw(seed[0], seed[1], 0, batch * n).reshape(batch, n)
    return jnp.concatenate([a, bodies[:, None]], axis=-1)


def lwe_encrypt_bool_seeded(
    key: jax.Array, s: jax.Array, msg: jax.Array, alpha: float
) -> tuple[jax.Array, jax.Array]:
    """Seeded variant of `lwe_encrypt_bool` (+/- 1/8 encoding)."""
    mu_true = jnp.uint32(int(f64_to_torus(0.125)))
    mu_false = jnp.uint32(int(f64_to_torus(-0.125)))
    mu = jnp.where(jnp.asarray(msg), mu_true, mu_false)
    return lwe_encrypt_torus_seeded(key, s, mu, alpha)


def lwe_encrypt_rows_limbs(
    key: jax.Array,
    s: jax.Array,
    mu: jax.Array,
    alpha: float,
    zero_mask: jax.Array | None = None,
    row_chunk: int = 1024,
) -> jax.Array:
    """Encrypt a 1-D batch of torus messages into a PLANAR-PADDED limb table.

    Returns int8 [R, 4*P] with P = lane_pad(n+1): column q*P + c holds
    balanced limb q of row coefficient c (mask coefficients c < n, body at
    c = n, zero padding above). The encryption itself — mask bits, noise,
    body — is bit-identical to ``lwe_encrypt_torus(key, s, mu, alpha)``
    (optionally with `zero_mask` rows zeroed); only the storage layout of
    the limb split differs from split_u32_limbs' interleaved [..., c*4+q].

    Why this shape: the table is consumed by one-hot int8 contractions
    (ops/keyswitch.digit_select_sum) where extra zero columns are free, and
    the chunked planar build keeps every fusion small: the mask is
    generated per row chunk by counter-exact threefry
    (torus.threefry2x32_bits), the body is placed by a one-hot
    multiply-add instead of a 701-wide concat, and the limb PLANES stack on
    a major axis instead of an interleaving relayout — with the very same
    encrypted values as the monolithic pipeline. Serves the key-switching
    key (key.gen_key_switching_key) and proxy re-keys (proxy_reenc).
    """
    n = s.shape[0]
    (rows,) = mu.shape
    if rows * n >= 1 << 32:
        raise ValueError("row table exceeds the 32-bit threefry counter range")
    p = lane_pad(n + 1)
    k_mask, k_noise = jax.random.split(key)
    noise = gaussian_torus(k_noise, alpha, (rows,))
    if zero_mask is None:
        zero_mask = jnp.zeros((rows,), bool)
    # largest divisor of `rows` <= row_chunk (compile-time constant)
    cs = next(c for c in range(min(row_chunk, rows), 0, -1) if rows % c == 0)
    steps = rows // cs
    xs = (
        mu.reshape(steps, cs),
        noise.reshape(steps, cs),
        zero_mask.reshape(steps, cs),
    )
    body_col = (jax.lax.iota(jnp.uint32, p) == n).astype(TORUS_DTYPE)
    s_pad = jnp.pad(s, (0, p - n))

    def step(start, x):
        mu_c, noise_c, zero_c = x
        bits = threefry2x32_bits(k_mask, start, cs * n).reshape(cs, n)
        a = jnp.pad(bits, ((0, 0), (0, p - n)))
        b = mu_c + noise_c + jnp.sum(a * s_pad, axis=-1, dtype=TORUS_DTYPE)
        row = a + b[:, None] * body_col[None, :]
        row = jnp.where(zero_c[:, None], jnp.uint32(0), row)
        limbs = split_u32_limbs_planar(row).reshape(cs, 4 * p)
        return start + jnp.uint32(cs * n), limbs

    _, limbs = jax.lax.scan(step, jnp.uint32(0), xs)
    return limbs.reshape(rows, 4 * p)


def lwe_rows_limbs_from_bodies(
    k_mask: jax.Array,
    bodies: jax.Array,
    n: int,
    zero_mask: jax.Array | None = None,
    row_chunk: int = 1024,
) -> jax.Array:
    """Rebuild an `lwe_encrypt_rows_limbs` table from its mask key + bodies.

    The masks are pseudorandom (threefry stream of `k_mask` — the FIRST
    split of the key `lwe_encrypt_rows_limbs` was called with), so a seeded
    serialization stores only (k_mask, bodies) and replays the table here,
    bit-identically (pinned by tests/test_serialization.py: the rebuilt
    CloudKey pytree equals the original exactly). No secret material is
    needed: bodies already contain mu + noise + <a, s>.
    """
    (rows,) = bodies.shape
    p = lane_pad(n + 1)
    if zero_mask is None:
        zero_mask = jnp.zeros((rows,), bool)
    cs = next(c for c in range(min(row_chunk, rows), 0, -1) if rows % c == 0)
    steps = rows // cs
    xs = (bodies.reshape(steps, cs), zero_mask.reshape(steps, cs))
    body_col = (jax.lax.iota(jnp.uint32, p) == n).astype(TORUS_DTYPE)

    def step(start, x):
        b_c, zero_c = x
        bits = threefry2x32_bits(k_mask, start, cs * n).reshape(cs, n)
        a = jnp.pad(bits, ((0, 0), (0, p - n)))
        row = a + b_c[:, None] * body_col[None, :]
        row = jnp.where(zero_c[:, None], jnp.uint32(0), row)
        limbs = split_u32_limbs_planar(row).reshape(cs, 4 * p)
        return start + jnp.uint32(cs * n), limbs

    _, limbs = jax.lax.scan(step, jnp.uint32(0), xs)
    return limbs.reshape(rows, 4 * p)


def lwe_encrypt_bool(
    key: jax.Array, s: jax.Array, msg: jax.Array, alpha: float
) -> jax.Array:
    """Boolean +/- 1/8 encoding (reference tlwe.rs:55-58)."""
    mu_true = jnp.uint32(int(f64_to_torus(0.125)))
    mu_false = jnp.uint32(int(f64_to_torus(-0.125)))
    mu = jnp.where(jnp.asarray(msg), mu_true, mu_false)
    return lwe_encrypt_torus(key, s, mu, alpha)


def lwe_phase(ct: jax.Array, s: jax.Array) -> jax.Array:
    """b - <a, s> (mod 2^32), uint32 [...]."""
    return ct[..., -1] - jnp.sum(ct[..., :-1] * s, axis=-1, dtype=TORUS_DTYPE)


def lwe_decrypt_bool(ct: jax.Array, s: jax.Array) -> jax.Array:
    """Sign test on the phase (reference tlwe.rs:60-68)."""
    return jax.lax.bitcast_convert_type(lwe_phase(ct, s), jnp.int32) >= 0


def lwe_encrypt_message(
    key: jax.Array,
    s: jax.Array,
    msg: jax.Array,
    message_modulus: int,
    alpha: float,
) -> jax.Array:
    """LWE message encoding msg/(2*modulus) for programmable bootstrapping.

    Reference: tlwe.rs:84-98.
    """
    msg = jnp.mod(jnp.asarray(msg), message_modulus)
    scale_t = np.uint32(f64_to_torus(1.0 / (2.0 * message_modulus)))
    mu = msg.astype(TORUS_DTYPE) * scale_t
    return lwe_encrypt_torus(key, s, mu, alpha)


def lwe_decrypt_message(ct: jax.Array, s: jax.Array, message_modulus: int):
    """Round the phase to the nearest message (reference tlwe.rs:111-126)."""
    phase = np.asarray(jax.device_get(lwe_phase(ct, s)), dtype=np.uint32)
    res_f64 = phase.astype(np.float64) / float(1 << 32)
    scale = 1.0 / (2.0 * message_modulus)
    return (res_f64 / scale + 0.5).astype(np.int64) % message_modulus


def lwe_trivial_bool(msg: jax.Array, n: int) -> jax.Array:
    """Noiseless maskless ciphertexts of boolean plaintexts: body = ±1/8,
    mask = 0 (decrypt under any key; gate linear forms treat them exactly
    like fresh encryptions). No reference analogue — the reference has no
    server-side plaintext injection."""
    msg = jnp.asarray(msg, dtype=bool)
    mu = jnp.uint32(int(f64_to_torus(0.125)))
    body = jnp.where(msg, mu, jnp.uint32(0) - mu)
    ct = jnp.zeros((*msg.shape, n + 1), dtype=TORUS_DTYPE)
    return ct.at[..., -1].set(body)


def lwe_trivial_message(msg, message_modulus: int, n: int) -> jax.Array:
    """Noiseless maskless ciphertexts under the msg/(2*modulus) PBS
    encoding (lwe_encrypt_message with zero mask and zero noise)."""
    msg = jnp.mod(jnp.asarray(msg), message_modulus)
    scale = np.uint32(f64_to_torus(1.0 / (2.0 * message_modulus)))
    ct = jnp.zeros((*msg.shape, n + 1), dtype=TORUS_DTYPE)
    return ct.at[..., -1].set(msg.astype(TORUS_DTYPE) * scale)


# ---------------------------------------------------------------------------
# Homomorphic linear operators (reference tlwe.rs:129-214)
# ---------------------------------------------------------------------------

def lwe_add(x, y):
    return x + y


def lwe_sub(x, y):
    return x - y


def lwe_neg(x):
    return neg_torus(x)


def _u32_scalar(multiplier: int) -> jnp.uint32:
    """Wrap a Python int (possibly negative) to uint32 mod 2^32."""
    return jnp.uint32(multiplier & 0xFFFFFFFF)


def lwe_mul(x, multiplier: int):
    """Scalar multiply of a ciphertext by a known integer, mod 2^32.

    No direct reference analog (the reference's Mul, tlwe.rs:160-176, is
    elementwise ciphertext*ciphertext used only by tests); the scalar form
    here is what AddMul/SubMul factor through. Negative multipliers wrap.
    """
    return x * _u32_scalar(multiplier)


def lwe_add_mul(x, y, multiplier: int):
    """x + multiplier*y (reference AddMul, tlwe.rs:185-195)."""
    return x + y * _u32_scalar(multiplier)


def lwe_sub_mul(x, y, multiplier: int):
    """x - multiplier*y (reference SubMul, tlwe.rs:204-214)."""
    return x - y * _u32_scalar(multiplier)


def lwe_add_bias(ct, bias: int):
    """Add a constant torus bias to the body column."""
    return ct.at[..., -1].add(jnp.uint32(bias))
