"""Fixed-seed golden vectors of our own pipeline (review round 1 item 3).

The vectors in tests/vectors/golden_tiny.npz were generated by
scripts/gen_golden_vectors.py at a pinned set of jax.random seeds. Any
numeric drift in keygen, encryption, blind rotation, extraction, key
switching, gates, MUX, or programmable bootstrapping fails here with a
named stage. Regenerate ONLY for intentional changes (and say so in the
commit message).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rs_tfhe_tpu import gates
from rs_tfhe_tpu.bootstrap import LutBootstrap
from rs_tfhe_tpu.key import CloudKey, SecretKey
from rs_tfhe_tpu.ops.blind_rotate import blind_rotate
from rs_tfhe_tpu.ops.extract import sample_extract
from rs_tfhe_tpu.ops.keyswitch import identity_key_switch
from rs_tfhe_tpu.params import TEST_TINY
from rs_tfhe_tpu.tlwe import lwe_encrypt_bool, lwe_encrypt_message

VEC = os.path.join(os.path.dirname(__file__), "vectors", "golden_tiny.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(VEC).items())


@pytest.fixture(scope="module")
def state():
    p = TEST_TINY
    sk = SecretKey.generate(jax.random.key(777), p)
    ck = CloudKey.generate(jax.random.key(778), sk)
    bits = jnp.asarray([True, False, True, True, False, False, True, False])
    a = lwe_encrypt_bool(jax.random.key(779), sk.lv0, bits, p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(jax.random.key(780), sk.lv0, ~bits, p.tlwe_lv0.alpha)
    return p, sk, ck, a, b


def test_keygen_and_encrypt(golden, state):
    p, sk, ck, a, b = state
    np.testing.assert_array_equal(np.asarray(sk.lv0), golden["sk_lv0"])
    np.testing.assert_array_equal(np.asarray(sk.lv1), golden["sk_lv1"])
    np.testing.assert_array_equal(np.asarray(ck.bsk[0]), golden["bsk_row0"])
    np.testing.assert_array_equal(
        np.asarray(ck.ksk_limbs[:64]), golden["ksk_limbs_head"]
    )
    np.testing.assert_array_equal(np.asarray(a), golden["ct_a"])


def test_blind_rotate_extract_keyswitch(golden, state):
    p, sk, ck, a, b = state
    lin = gates._nand_lin(a, b)
    acc = blind_rotate(lin, ck.testvec, ck.bsk, p)
    np.testing.assert_array_equal(np.asarray(acc), golden["blind_rotate_out"])
    lv1 = sample_extract(acc)
    np.testing.assert_array_equal(np.asarray(lv1), golden["extract_out"])
    ks = identity_key_switch(lv1, ck.ksk_limbs, p)
    np.testing.assert_array_equal(np.asarray(ks), golden["keyswitch_out"])


def test_gate_mux_pbs(golden, state):
    p, sk, ck, a, b = state
    np.testing.assert_array_equal(
        np.asarray(gates.nand(a, b, ck)), golden["nand_out"]
    )
    np.testing.assert_array_equal(
        np.asarray(gates.mux(a, b, a, ck)), golden["mux_out"]
    )
    msgs = jnp.asarray([0, 1, 2, 3, 4, 5, 6, 7], jnp.uint32)
    ct_m = lwe_encrypt_message(jax.random.key(781), sk.lv0, msgs, 8,
                               p.tlwe_lv0.alpha)
    pbs = LutBootstrap().bootstrap_func(ct_m, lambda v: (v * 5 + 1) % 8, 8, ck)
    np.testing.assert_array_equal(np.asarray(pbs), golden["pbs_out"])
