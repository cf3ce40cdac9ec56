"""TLWE round-trip and semantic-hiding tests (reference tlwe.rs:281-304)."""

import jax
import jax.numpy as jnp
import numpy as np

from rs_tfhe_tpu import tlwe

#: reference parity: tlwe.rs:281-304 runs 10,000 trials; encryption is one
#: batched op here so the larger sample costs nothing
TRIALS = 10_000


def test_encrypt_decrypt_roundtrip(tiny, sk, sk_dirty, rng):
    msgs = jnp.asarray(rng.integers(0, 2, TRIALS).astype(bool))
    ct = tlwe.lwe_encrypt_bool(jax.random.key(0), sk.lv0, msgs, tiny.tlwe_lv0.alpha)
    dec = tlwe.lwe_decrypt_bool(ct, sk.lv0)
    assert bool(jnp.all(dec == msgs))
    # wrong key decrypts ~50% ("key_dirty" check); at 10k trials a fair
    # coin stays within +/-5 sigma = +/-2.5% of 0.5
    dec_dirty = np.asarray(tlwe.lwe_decrypt_bool(ct, sk_dirty.lv0))
    frac = np.mean(dec_dirty != np.asarray(msgs))
    assert 0.475 < frac < 0.525


def test_lv1_roundtrip(tiny, sk, rng):
    msgs = jnp.asarray(rng.integers(0, 2, TRIALS).astype(bool))
    ct = tlwe.lwe_encrypt_bool(jax.random.key(1), sk.lv1, msgs, tiny.tlwe_lv1.alpha)
    assert bool(jnp.all(tlwe.lwe_decrypt_bool(ct, sk.lv1) == msgs))


def test_linear_operators(tiny, sk, rng):
    """Homomorphic +, -, neg, add_mul, sub_mul preserve phases."""
    m = jnp.asarray(rng.integers(0, 2, 32).astype(bool))
    a = tlwe.lwe_encrypt_bool(jax.random.key(2), sk.lv0, m, tiny.tlwe_lv0.alpha)
    b = tlwe.lwe_encrypt_bool(jax.random.key(3), sk.lv0, ~m, tiny.tlwe_lv0.alpha)
    pa = tlwe.lwe_phase(a, sk.lv0)
    pb = tlwe.lwe_phase(b, sk.lv0)
    assert bool(jnp.all(tlwe.lwe_phase(tlwe.lwe_add(a, b), sk.lv0) == pa + pb))
    assert bool(jnp.all(tlwe.lwe_phase(tlwe.lwe_sub(a, b), sk.lv0) == pa - pb))
    assert bool(
        jnp.all(tlwe.lwe_phase(tlwe.lwe_neg(a), sk.lv0) == jnp.zeros_like(pa) - pa)
    )
    assert bool(
        jnp.all(
            tlwe.lwe_phase(tlwe.lwe_add_mul(a, b, 2), sk.lv0)
            == pa + pb * jnp.uint32(2)
        )
    )
    assert bool(
        jnp.all(
            tlwe.lwe_phase(tlwe.lwe_sub_mul(a, b, 2), sk.lv0)
            == pa - pb * jnp.uint32(2)
        )
    )
    # negative multipliers wrap mod 2^32 instead of raising (NumPy 2
    # uint32(-k) semantics; lwe_mul masks explicitly)
    assert bool(
        jnp.all(
            tlwe.lwe_phase(tlwe.lwe_mul(a, -3), sk.lv0)
            == pa * jnp.uint32((-3) & 0xFFFFFFFF)
        )
    )
    assert bool(
        jnp.all(
            tlwe.lwe_phase(tlwe.lwe_add_mul(a, b, -1), sk.lv0) == pa - pb
        )
    )


def test_lwe_message_roundtrip(tiny, sk, rng):
    """Multi-bit LWE message encoding (reference tlwe.rs:84-126)."""
    modulus = 8
    msgs = jnp.asarray(rng.integers(0, modulus, 64))
    ct = tlwe.lwe_encrypt_message(
        jax.random.key(4), sk.lv0, msgs, modulus, tiny.tlwe_lv0.alpha
    )
    dec = tlwe.lwe_decrypt_message(ct, sk.lv0, modulus)
    assert np.array_equal(dec, np.asarray(msgs))


def test_threefry_chunked_bits_match_jax(rng):
    """torus.threefry2x32_bits reproduces jax.random.bits exactly.

    The chunked-keygen pipeline (lwe_encrypt_rows_limbs) depends on this
    counter-exact equivalence; it is what keeps the scan-chunked key tables
    bit-identical to the monolithic formulation (and the golden vectors
    stable).
    """
    from rs_tfhe_tpu.torus import threefry2x32_bits

    for seed, (r, c) in [(0, (12, 10)), (42, (7, 13)), (9, (36, 700))]:
        key = jax.random.key(seed)
        direct = jax.random.bits(key, (r, c), dtype=jnp.uint32).ravel()
        whole = threefry2x32_bits(key, 0, r * c)
        np.testing.assert_array_equal(np.asarray(whole), np.asarray(direct))
        # arbitrary offset/length windows
        for start, count in [(0, 7), (5, 64), (r * c - 9, 9)]:
            win = threefry2x32_bits(key, start, count)
            np.testing.assert_array_equal(
                np.asarray(win), np.asarray(direct[start:start + count])
            )


def test_encrypt_rows_limbs_matches_monolithic(tiny, sk, rng):
    """Scan-chunked planar row encryption encodes exactly the rows that the
    monolithic lwe_encrypt_torus produces (same mask bits, noise, body)."""
    from rs_tfhe_tpu.torus import lane_pad

    rows = 360  # not a multiple of the default chunk; exercises divisor pick
    n = int(sk.lv0.shape[0])
    pw = lane_pad(n + 1)
    mu = jnp.asarray(rng.integers(0, 1 << 32, rows, dtype=np.uint32))
    zero_mask = jnp.asarray(rng.integers(0, 4, rows) == 0)
    key = jax.random.key(123)
    alpha = tiny.ksk_alpha

    ref = tlwe.lwe_encrypt_torus(key, sk.lv0, mu, alpha)
    ref = np.asarray(jnp.where(zero_mask[:, None], jnp.uint32(0), ref))

    for chunk in (1024, 36, 7):
        got = tlwe.lwe_encrypt_rows_limbs(
            key, sk.lv0, mu, alpha, zero_mask=zero_mask, row_chunk=chunk
        )
        assert got.shape == (rows, 4 * pw)
        l = np.asarray(got, dtype=np.int64).reshape(rows, 4, pw)
        # padding columns are zero in every limb plane
        np.testing.assert_array_equal(l[:, :, n + 1:], 0)
        # planar limbs recombine to the reference rows mod 2^32
        acc = np.zeros((rows, n + 1), dtype=np.uint32)
        for q in range(4):
            acc += (l[:, q, : n + 1].astype(np.uint32)) << np.uint32(8 * q)
        np.testing.assert_array_equal(acc, ref)
