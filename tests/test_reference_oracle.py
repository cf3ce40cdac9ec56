"""Cross-check against the reference-quirk oracle (reference_oracle.py).

Each test pins one DOCUMENTED deviation between this implementation and the
reference, proving it is the ONLY difference on that path:

  centered decomposition   <-> truncating (trgsw.rs:144-171)
  exact negation           <-> MAX - x    (trgsw.rs:317-326, trlwe.rs:114)
  lv1-width no-KS extract  <-> lv0-width hybrid (trlwe.rs:122-136)

and that where we match the reference we match it EXACTLY (key switching,
blind rotation under matching conventions, full gate bootstrap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import reference_oracle as RO
from rs_tfhe_tpu import gates
from rs_tfhe_tpu.key import CloudKey, SecretKey
from rs_tfhe_tpu.ops.blind_rotate import blind_rotate
from rs_tfhe_tpu.ops.poly import monomial_rotate
from rs_tfhe_tpu.ops.decompose import gadget_decompose
from rs_tfhe_tpu.ops.extract import sample_extract, sample_extract_to_lv0_width
from rs_tfhe_tpu.ops.keyswitch import identity_key_switch
from rs_tfhe_tpu.params import TEST_TINY
from rs_tfhe_tpu.tlwe import lwe_decrypt_bool, lwe_encrypt_bool, lwe_phase


@pytest.fixture(scope="module")
def keys():
    sk = SecretKey.generate(jax.random.key(101), TEST_TINY)
    ck = CloudKey.generate(jax.random.key(102), sk)
    return sk, ck


def test_decomposition_round_bit_is_only_difference(rng):
    """ours(x) == reference_decomposition(x + round_bit): the centering
    half-step is the single deviation from trgsw.rs:144-171."""
    p = TEST_TINY
    ab = rng.integers(0, 1 << 32, (2, p.n1), dtype=np.uint32)
    ours = np.asarray(
        gadget_decompose(jnp.asarray(ab)[None], p)[0], dtype=np.int64
    )  # [2L, N]
    shifted = (ab.astype(np.uint64) + np.uint64(p.decomposition_round_bit)).astype(
        np.uint32
    )
    ref_on_shifted = RO.decomposition(shifted, p, centered=False)
    np.testing.assert_array_equal(ours, ref_on_shifted)
    # and the error intervals differ exactly as documented
    g = p.trgsw_lv1
    step = 1 << (32 - g.l * g.bgbit)

    def recon(digits):
        acc = np.zeros(p.n1, dtype=np.int64)
        for i in range(g.l):
            acc += digits[i] << (32 - (i + 1) * g.bgbit)
        return acc

    err_ref = (
        (RO.decomposition(ab, p, centered=False)[0 : g.l], ab[0])
    )
    e = (recon(err_ref[0]) - err_ref[1].astype(np.int64)) % (1 << 32)
    e = np.where(e >= 1 << 31, e - (1 << 32), e)
    assert e.min() >= -step + 1 and e.max() <= 0  # truncating: (-step, 0]
    e2 = (recon(ours[0 : g.l]) - ab[0].astype(np.int64)) % (1 << 32)
    e2 = np.where(e2 >= 1 << 31, e2 - (1 << 32), e2)
    assert abs(e2).max() <= step // 2  # centered: +/- step/2


def test_monomial_rotation_negation_off_by_one_only(rng):
    """X^k rotation: our exact negation vs the reference's MAX - x differ
    by exactly +1 on wrapped coefficients, nowhere else."""
    n = TEST_TINY.n1
    a = rng.integers(0, 1 << 32, (1, n), dtype=np.uint32)
    for k in (0, 1, 7, n - 1, n, n + 5, 2 * n - 1):
        ours = np.asarray(monomial_rotate(jnp.asarray(a), jnp.asarray([k])))[0]
        ref = RO.polymul_x_k(a[0], k, RO.neg_ref)
        exact = RO.polymul_x_k(a[0], k, RO.neg_exact)
        np.testing.assert_array_equal(ours, exact)
        diff = (ours - ref).astype(np.uint32)
        assert set(np.unique(diff)) <= {0, 1}, k
        # the +1 set is exactly the negated (wrapped) positions
        if 0 < k < n:
            assert np.count_nonzero(diff) == k
        elif n < k < 2 * n:
            assert np.count_nonzero(diff) == (2 * n - k)
    # MAX - 0 = -1 differs from exact -0 = 0 on every wrapped zero
    z = np.zeros((1, n), dtype=np.uint32)
    ours_z = np.asarray(monomial_rotate(jnp.asarray(z), jnp.asarray([5])))[0]
    ref_z = RO.polymul_x_k(z[0], 5, RO.neg_ref)
    assert np.count_nonzero(ours_z - ref_z) == 5  # MAX - 0 = -1 != 0


def test_sample_extract_parity(rng):
    p = TEST_TINY
    trlwe = rng.integers(0, 1 << 32, (2, p.n1), dtype=np.uint32)
    for k in (0, 3, p.n1 - 1):
        ours = np.asarray(sample_extract(jnp.asarray(trlwe)[None], k))[0]
        exact = RO.sample_extract(trlwe, k, RO.neg_exact)
        ref = RO.sample_extract(trlwe, k, RO.neg_ref)
        np.testing.assert_array_equal(ours, exact)
        diff = (ours - ref).astype(np.uint32)
        assert set(np.unique(diff)) <= {0, 1}
        assert np.count_nonzero(diff) == p.n1 - 1 - k  # the negated tail


def test_hybrid_extract_faithful(rng):
    """sample_extract_to_lv0_width reproduces sample_extract_index_2's
    index arithmetic (n0 in place of N) exactly, modulo exact negation."""
    p = TEST_TINY
    trlwe = rng.integers(0, 1 << 32, (2, p.n1), dtype=np.uint32)
    ours = np.asarray(sample_extract_to_lv0_width(jnp.asarray(trlwe)[None], p.n0))[0]
    ref_exactneg = RO.sample_extract(trlwe, 0, RO.neg_exact, width=p.n0)
    np.testing.assert_array_equal(ours, ref_exactneg)


def test_keyswitch_exact_parity(keys, rng):
    """Our one-hot-matmul key switch == the reference's gather-subtract
    loop, bit for bit, on the same KSK."""
    sk, ck = keys
    p = TEST_TINY
    ksk_rows = RO.ksk_rows_from_limbs(np.asarray(ck.ksk_limbs), p.n0)
    src = rng.integers(0, 1 << 32, (3, p.n1 + 1), dtype=np.uint32)
    ours = np.asarray(identity_key_switch(jnp.asarray(src), ck.ksk_limbs, p))
    for i in range(3):
        ref = RO.identity_key_switching(src[i], ksk_rows, p)
        np.testing.assert_array_equal(ours[i], ref)


def test_blind_rotate_matches_exact_oracle(keys, rng):
    """Our batched blind rotation == the reference loop run with
    our conventions (centered decomposition, exact negation) — proving the
    circulant path computes the same integers as the schoolbook."""
    sk, ck = keys
    p = TEST_TINY
    ct = rng.integers(0, 1 << 32, (2, p.n0 + 1), dtype=np.uint32)
    ours = np.asarray(
        blind_rotate(jnp.asarray(ct), ck.testvec, ck.bsk, p)
    )
    tv = np.asarray(ck.testvec)
    bsk = np.asarray(ck.bsk)
    for i in range(2):
        ref = RO.blind_rotate(ct[i], tv, bsk, p, centered=True, neg=RO.neg_exact)
        np.testing.assert_array_equal(ours[i], ref)


def test_reference_quirks_do_not_change_decrypted_gates(keys, rng):
    """Running the FULL reference pipeline (truncating decomposition,
    MAX - x negation) through the oracle yields the same decrypted NAND
    outputs as our pipeline: the deviations are numeric, not semantic."""
    sk, ck = keys
    p = TEST_TINY
    bits = rng.integers(0, 2, 8).astype(bool)
    a = lwe_encrypt_bool(jax.random.key(7), sk.lv0, jnp.asarray(bits),
                         p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(jax.random.key(8), sk.lv0, jnp.asarray(~bits),
                         p.tlwe_lv0.alpha)
    ours = np.asarray(lwe_decrypt_bool(gates.nand(a, b, ck), sk.lv0))

    ksk_rows = RO.ksk_rows_from_limbs(np.asarray(ck.ksk_limbs), p.n0)
    tv, bsk = np.asarray(ck.testvec), np.asarray(ck.bsk)
    lin = np.asarray(gates._nand_lin(a, b))
    for i in range(8):
        ref_out = RO.gate_bootstrap(lin[i], tv, bsk, ksk_rows, p,
                                    centered=False, neg=RO.neg_ref)
        phase = np.asarray(
            lwe_phase(jnp.asarray(ref_out)[None], sk.lv0)
        )[0]
        ref_bit = phase.astype(np.int32) >= 0
        assert bool(ref_bit) == bool(ours[i])
        assert bool(ref_bit) == (not (bits[i] and not bits[i]))  # NAND truth


def test_reference_mux_hybrid_is_broken_ours_is_not(keys, rng):
    """The reference's keyswitch-free MUX (gates.rs:157-183) pairs the
    hybrid extract's truncated lv1 mask with lv0 key bits in the final
    bootstrap — its own tests only cover mux_naive (gates.rs:672). At
    TEST_TINY geometry (n0=16 < N=64) the oracle shows it decrypts
    incorrectly on some inputs, while our corrected composition is exact.
    """
    sk, ck = keys
    p = TEST_TINY
    trials = 12
    sel = rng.integers(0, 2, trials).astype(bool)
    x = rng.integers(0, 2, trials).astype(bool)
    y = rng.integers(0, 2, trials).astype(bool)
    a = lwe_encrypt_bool(jax.random.key(21), sk.lv0, jnp.asarray(sel), p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(jax.random.key(22), sk.lv0, jnp.asarray(x), p.tlwe_lv0.alpha)
    c = lwe_encrypt_bool(jax.random.key(23), sk.lv0, jnp.asarray(y), p.tlwe_lv0.alpha)
    want = np.where(sel, x, y)

    ours = np.asarray(lwe_decrypt_bool(gates.mux(a, b, c, ck), sk.lv0))
    np.testing.assert_array_equal(ours, want)

    ksk_rows = RO.ksk_rows_from_limbs(np.asarray(ck.ksk_limbs), p.n0)
    tv, bsk = np.asarray(ck.testvec), np.asarray(ck.bsk)
    an, bn, cn = np.asarray(a), np.asarray(b), np.asarray(c)
    wrong = 0
    for i in range(trials):
        out = RO.mux(an[i], bn[i], cn[i], tv, bsk, ksk_rows, p, centered=False)
        phase = np.asarray(lwe_phase(jnp.asarray(out)[None], sk.lv0))[0]
        if bool(phase.astype(np.int32) >= 0) != bool(want[i]):
            wrong += 1
    assert wrong > 0, (
        "reference hybrid MUX unexpectedly correct at TEST_TINY — "
        "re-examine the documented deviation"
    )
