"""Ciphertext x ciphertext radix multiplication (models.mul_radix) — a
capability beyond the reference (its only multiplications are plaintext
scalars, tlwe.rs:160-214).

TEST_TINY's N=64 ring cannot hold modulus-32 LUT margins (the mod-switch
floor alone is ~1 sigma with the corrected 1/(4m) decision distance), so
these tests run a dedicated N=512 tiny set (~6.7 sigma on the 8-summand
columns) — deterministic enough for CI. Production use:
SECURITY_128_BIT_NIBBLE (6.5 sigma certified; the production-size run is
the golden phase of chip_smoke.py)."""

import jax
import numpy as np
import pytest

from rs_tfhe_tpu.key import CloudKey, SecretKey
from rs_tfhe_tpu.models.arithmetic import (
    _col_bounds,
    decrypt_radix,
    encrypt_radix,
    mul_radix,
)
from rs_tfhe_tpu.params import TfheParams, TlweParams, TrgswParams, TrlweParams

MP = TfheParams(
    security_bits=0,
    description="insecure tiny set with modulus-32 LUT margins (N=512)",
    tlwe_lv0=TlweParams(n=16, alpha=1.0e-9),
    tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
    trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
    trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8,
                          alpha=1.0e-12),
)


@pytest.fixture(scope="module")
def mkeys():
    sk = SecretKey.generate(jax.random.key(50), MP)
    ck = CloudKey.generate(jax.random.key(51), sk)
    return sk, ck


def test_col_bounds_stay_under_modulus():
    # D=4, base=4 is the no-normalization envelope
    assert max(_col_bounds(4, 4)) < 32
    assert max(_col_bounds(2, 4)) < 32
    # D=8 overflows the single-chunk bound — mul_radix covers it with the
    # greedy normalization rounds
    assert max(_col_bounds(8, 4)) >= 32


def test_mul_radix_4bit(mkeys, rng):
    """2-digit base-4 operands (4-bit x 4-bit -> 8-bit product)."""
    sk, ck = mkeys
    xs = rng.integers(0, 16, 6)
    ys = rng.integers(0, 16, 6)
    a = encrypt_radix(jax.random.key(52), sk.lv0, xs, 2, MP, base_bits=2)
    b = encrypt_radix(jax.random.key(53), sk.lv0, ys, 2, MP, base_bits=2)
    out = mul_radix(a, b, ck, base_bits=2)
    assert out.shape[-2] == 4
    got = np.asarray(decrypt_radix(out, sk.lv0, base_bits=2))
    np.testing.assert_array_equal(got, xs * ys)


def test_mul_radix_8bit(mkeys, rng):
    """4-digit base-4 operands (8-bit x 8-bit -> 16-bit product)."""
    sk, ck = mkeys
    xs = rng.integers(0, 256, 4)
    ys = rng.integers(0, 256, 4)
    a = encrypt_radix(jax.random.key(54), sk.lv0, xs, 4, MP, base_bits=2)
    b = encrypt_radix(jax.random.key(55), sk.lv0, ys, 4, MP, base_bits=2)
    out = mul_radix(a, b, ck, base_bits=2)
    assert out.shape[-2] == 8
    got = np.asarray(decrypt_radix(out, sk.lv0, base_bits=2))
    np.testing.assert_array_equal(got, xs * ys)


def test_mul_radix_16bit(mkeys, rng):
    """8-digit base-4 operands (16-bit x 16-bit -> 32-bit product) — wide
    enough that the carry-save columns overflow a single modulus-32 chunk
    (max _col_bounds(8, 4) = 49 >= 32) and the greedy normalization rounds
    must fire."""
    sk, ck = mkeys
    xs = rng.integers(0, 1 << 16, 3)
    ys = rng.integers(0, 1 << 16, 3)
    a = encrypt_radix(jax.random.key(56), sk.lv0, xs, 8, MP, base_bits=2)
    b = encrypt_radix(jax.random.key(57), sk.lv0, ys, 8, MP, base_bits=2)
    out = mul_radix(a, b, ck, base_bits=2)
    assert out.shape[-2] == 16
    got = np.asarray(decrypt_radix(out, sk.lv0, base_bits=2))
    np.testing.assert_array_equal(got, np.asarray(xs) * np.asarray(ys))


def test_mul_radix_multi_value_matches(mkeys, rng):
    """multi_value=True: stage-2/3 test-vector pairs factored through one
    blind rotation each (review round 4 item 4) — decode-identical products."""
    sk, ck = mkeys
    xs = rng.integers(0, 256, 4)
    ys = rng.integers(0, 256, 4)
    a = encrypt_radix(jax.random.key(58), sk.lv0, xs, 4, MP, base_bits=2)
    b = encrypt_radix(jax.random.key(59), sk.lv0, ys, 4, MP, base_bits=2)
    out = mul_radix(a, b, ck, base_bits=2, multi_value=True)
    got = np.asarray(decrypt_radix(out, sk.lv0, base_bits=2))
    np.testing.assert_array_equal(got, xs * ys)


def test_mul_radix_multi_value_norms_within_margin():
    """The stage-2 factoring norms keep the certified NIBBLE column margin
    >= 6 sigma, and the column-stage factorings mul_radix REFUSES would
    indeed break it (the numbers documented in _mul_mv)."""
    from rs_tfhe_tpu.models.arithmetic import _mul_mv
    from rs_tfhe_tpu.params import SECURITY_128_BIT_NIBBLE as PN
    from rs_tfhe_tpu.utils.noise import lut_margin

    fams = _mul_mv(2, PN)
    worst = max(fams["pair"].norms)
    assert worst < 7, worst
    s, p = lut_margin(PN, 32, 8, mv_norm=worst)
    assert s >= 6.0 and p < 1e-9, (s, p)
    # the refused column factorings really do sit under the bar
    s_refused, _ = lut_margin(PN, 32, 8, mv_norm=9.8)
    assert s_refused < 6.0, s_refused
