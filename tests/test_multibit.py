"""Multi-bit (pair-grouped) blind rotation: correctness + noise model.

New capability beyond the reference (its rotation is bit-serial,
trgsw.rs:209-223): one external product against a word-domain combination
of four pair-indicator TRGSWs advances the chain by TWO mask elements,
halving the sequential CMUX chain — the small-batch latency lever.
These tests pin the XLA path on CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rs_tfhe_tpu import tlwe
from rs_tfhe_tpu.key import CloudKey, SecretKey
from rs_tfhe_tpu.ops.blind_rotate import blind_rotate_mb, modswitch
from rs_tfhe_tpu.ops.extract import sample_extract
from rs_tfhe_tpu.ops.keyswitch import identity_key_switch
from rs_tfhe_tpu.torus import f64_to_torus
from rs_tfhe_tpu.utils.noise import estimate, measure_phase_noise

A = np.array([False, False, True, True] * 2)
B = np.array([False, True, False, True] * 2)


@pytest.fixture(scope="module")
def ck_mb(sk):
    return CloudKey.generate(jax.random.key(7), sk, multibit=True)


def _bootstrap_mb(ct, ck):
    acc = blind_rotate_mb(ct, ck.testvec, ck.bsk_mb, ck.params)
    return identity_key_switch(sample_extract(acc, 0), ck.ksk_limbs, ck.params)


def test_mb_keygen_preserves_standard_streams(sk, ck, ck_mb):
    """multibit=True must not perturb the KSK/BSK PRNG streams (golden
    vectors and seeded replay depend on them): the standard key material
    is bit-identical, mb entries ride on a folded-in stream."""
    np.testing.assert_array_equal(np.asarray(ck.bsk), np.asarray(ck_mb.bsk))
    np.testing.assert_array_equal(
        np.asarray(ck.ksk_limbs), np.asarray(ck_mb.ksk_limbs)
    )
    g2 = ck_mb.params.trgsw_lv1
    assert ck_mb.bsk_mb.shape == (
        ck_mb.params.n0 // 2, 4, 2 * g2.l, 2, ck_mb.params.n1
    )
    # the key carries only bsk_mb beside the standard material: no
    # derived layouts
    assert not hasattr(ck_mb, "bsk_mb_vecs")


def test_mb_gate_truth_table(tiny, sk, ck_mb):
    """NAND through the mb bootstrap: linear form -(a+b)+1/8, one mb
    rotation, extract, key switch — truth table exact (reference gate
    semantics, gates.rs:54-58, with half the chain length)."""
    cta = tlwe.lwe_encrypt_bool(
        jax.random.key(100), sk.lv0, jnp.asarray(A), tiny.tlwe_lv0.alpha
    )
    ctb = tlwe.lwe_encrypt_bool(
        jax.random.key(101), sk.lv0, jnp.asarray(B), tiny.tlwe_lv0.alpha
    )
    lin = jnp.zeros_like(cta) - (cta + ctb)
    lin = lin.at[:, -1].add(jnp.uint32(int(f64_to_torus(0.125))))
    out = _bootstrap_mb(lin, ck_mb)
    dec = np.asarray(tlwe.lwe_decrypt_bool(out, sk.lv0))
    assert np.array_equal(dec, ~(A & B))


def test_mb_acc_plaintext_matches_standard(tiny, sk, ck_mb, rng):
    """The mb accumulator decrypts to the SAME rotated test vector as the
    standard chain (identical rotation exponent b~ + sum a~_i s_i; only the
    noise realization differs)."""
    from rs_tfhe_tpu.ops.blind_rotate import blind_rotate
    from rs_tfhe_tpu.trlwe import trlwe_phase

    ct = tlwe.lwe_encrypt_bool(
        jax.random.key(5), sk.lv0,
        jnp.asarray(rng.integers(0, 2, 4).astype(bool)),
        tiny.tlwe_lv0.alpha,
    )
    acc_std = blind_rotate(ct, ck_mb.testvec, ck_mb.bsk, tiny)
    acc_mb = blind_rotate_mb(ct, ck_mb.testvec, ck_mb.bsk_mb, tiny)
    ph_std = np.asarray(trlwe_phase(acc_std, sk.lv1)).astype(np.int64)
    ph_mb = np.asarray(trlwe_phase(acc_mb, sk.lv1)).astype(np.int64)
    # same plaintext plateau: wrapped difference far below the 1/8 encoding
    diff = (ph_mb - ph_std) % (1 << 32)
    diff = np.minimum(diff, (1 << 32) - diff)
    assert diff.max() < (1 << 32) / 64


def test_mb_noise_within_model(tiny, sk, ck_mb, rng):
    """Empirical mb bootstrap noise obeys estimate(mb_group=2) — the 2x
    BSK-variance model for the 4-TRGSW word-domain combination."""
    est = estimate(tiny, mb_group=2)
    bits = jnp.asarray(rng.integers(0, 2, 64).astype(bool))
    a = tlwe.lwe_encrypt_bool(
        jax.random.key(1), sk.lv0, bits, tiny.tlwe_lv0.alpha
    )
    b = tlwe.lwe_encrypt_bool(
        jax.random.key(2), sk.lv0, ~bits, tiny.tlwe_lv0.alpha
    )
    lin = jnp.zeros_like(a) - (a + b)
    lin = lin.at[:, -1].add(jnp.uint32(int(f64_to_torus(0.125))))
    out = _bootstrap_mb(lin, ck_mb)  # NAND(x, ~x) == True always
    noise = measure_phase_noise(out, sk.lv0, np.uint32(f64_to_torus(0.125)))
    assert np.abs(noise).max() < 6.0 * est.bootstrap_out_std + 1e-9
    assert noise.std() < 2.0 * est.bootstrap_out_std + 1e-9
    # and the model itself orders correctly: mb is noisier than standard
    assert est.bootstrap_out_std >= estimate(tiny).bootstrap_out_std


def test_mb_key_routes_gates_at_small_batch(tiny, sk, ck_mb):
    """gates.* on a multibit CloudKey auto-route batches <= 2 through the
    grouped chain (ops/blind_rotate.blind_rotate's mb dispatch) and stay
    correct; the opt-in is generating the key with multibit=True."""
    from rs_tfhe_tpu import gates

    a = tlwe.lwe_encrypt_bool(
        jax.random.key(30), sk.lv0, jnp.asarray(A[:2]), tiny.tlwe_lv0.alpha
    )
    b = tlwe.lwe_encrypt_bool(
        jax.random.key(31), sk.lv0, jnp.asarray(B[:2]), tiny.tlwe_lv0.alpha
    )
    out = gates.xor(a, b, ck_mb)
    dec = np.asarray(tlwe.lwe_decrypt_bool(out, sk.lv0))
    assert np.array_equal(dec, A[:2] ^ B[:2])


def test_mb_modswitch_consistency(tiny, sk, ck_mb):
    """The mb path consumes the same modswitched exponents as the standard
    path (reference trgsw.rs:202-211 rounding)."""
    ct = jnp.asarray(
        np.random.default_rng(3).integers(0, 1 << 32, (2, tiny.n0 + 1),
                                          dtype=np.uint32)
    )
    a = modswitch(ct[:, : tiny.n0], tiny)
    assert int(a.max()) < 2 * tiny.n1 and int(a.min()) >= 0
