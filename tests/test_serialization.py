"""Key checkpoint/resume tests (absent in the reference — SURVEY.md §5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from rs_tfhe_tpu import gates
from rs_tfhe_tpu.tlwe import lwe_decrypt_bool, lwe_encrypt_bool
from rs_tfhe_tpu.utils.serialization import (
    load_cloud_key,
    load_secret_key,
    save_cloud_key,
    save_secret_key,
)


def test_secret_key_roundtrip(sk, tmp_path):
    p = tmp_path / "sk.npz"
    save_secret_key(p, sk)
    sk2 = load_secret_key(p)
    np.testing.assert_array_equal(np.asarray(sk.lv0), np.asarray(sk2.lv0))
    np.testing.assert_array_equal(np.asarray(sk.lv1), np.asarray(sk2.lv1))
    assert sk2.params == sk.params


def test_cloud_key_roundtrip_and_use(sk, ck, tmp_path):
    p = tmp_path / "ck.npz"
    save_cloud_key(p, ck)
    ck2 = load_cloud_key(p)
    assert ck2.params == ck.params

    a_bits = jnp.asarray([True, False])
    b_bits = jnp.asarray([True, True])
    ka, kb = jax.random.split(jax.random.key(11))
    a = lwe_encrypt_bool(ka, sk.lv0, a_bits, sk.params.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(kb, sk.lv0, b_bits, sk.params.tlwe_lv0.alpha)
    out = gates.nand(a, b, ck2)
    np.testing.assert_array_equal(
        np.asarray(lwe_decrypt_bool(out, sk.lv0)), [False, True]
    )


def test_kind_mismatch_rejected(sk, tmp_path):
    p = tmp_path / "sk.npz"
    save_secret_key(p, sk)
    import pytest

    with pytest.raises(ValueError):
        load_cloud_key(p)


def test_cloud_key_seeded_roundtrip_bit_exact(sk, ck, tmp_path):
    """Seeded serialization stores only (generate seed, ciphertext bodies)
    — ~9x smaller files — and the load-time mask replay reconstructs the
    ORIGINAL CloudKey bit-for-bit (every pytree leaf equal), then works
    end-to-end through a bootstrapped gate."""
    path = tmp_path / "ck_seeded.npz"
    save_cloud_key(path, ck, seeded=True)
    ck2 = load_cloud_key(path)

    np.testing.assert_array_equal(np.asarray(ck2.ksk_limbs),
                                  np.asarray(ck.ksk_limbs))
    np.testing.assert_array_equal(np.asarray(ck2.bsk), np.asarray(ck.bsk))
    np.testing.assert_array_equal(np.asarray(ck2.testvec),
                                  np.asarray(ck.testvec))
    # every pytree leaf round-trips; the key holds no derived layouts
    assert [f.name for f in dataclasses.fields(ck2)] == [
        "testvec", "ksk_limbs", "bsk", "params", "gen_seed", "bsk_mb"]
    for x, y in zip(jax.tree_util.tree_leaves(ck),
                    jax.tree_util.tree_leaves(ck2)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    # seeded file is much smaller than the full one
    full = tmp_path / "ck_full.npz"
    save_cloud_key(full, ck)
    assert path.stat().st_size < 0.6 * full.stat().st_size

    msgs = np.array([True, False, True])
    a = lwe_encrypt_bool(jax.random.key(2), sk.lv0, jnp.asarray(msgs),
                         sk.params.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(jax.random.key(3), sk.lv0, jnp.asarray(~msgs),
                         sk.params.tlwe_lv0.alpha)
    out = gates.nand(a, b, ck2)
    np.testing.assert_array_equal(
        np.asarray(lwe_decrypt_bool(out, sk.lv0)), ~(msgs & ~msgs))


def test_seeded_save_requires_generated_key(tmp_path):
    import pytest

    from rs_tfhe_tpu.key import CloudKey
    from rs_tfhe_tpu.params import TEST_TINY

    ck = CloudKey.generate_no_ksk(TEST_TINY)
    with pytest.raises(ValueError, match="gen_seed"):
        save_cloud_key(tmp_path / "x.npz", ck, seeded=True)


def test_reenc_key_roundtrip_and_use(sk, sk_dirty, tmp_path):
    """Proxy re-key persistence: saved/loaded key re-encrypts correctly."""
    from rs_tfhe_tpu import proxy_reenc
    from rs_tfhe_tpu.utils.serialization import load_reenc_key, save_reenc_key

    p = sk.params
    rk = proxy_reenc.new_symmetric(
        jax.random.key(21), sk.lv0, sk_dirty.lv0, p)
    path = tmp_path / "rk.npz"
    save_reenc_key(path, rk)
    rk2 = load_reenc_key(path)
    np.testing.assert_array_equal(np.asarray(rk2.table_limbs),
                                  np.asarray(rk.table_limbs))
    assert (rk2.basebit, rk2.t) == (rk.basebit, rk.t)

    msgs = np.array([True, False, True, False])
    ct = lwe_encrypt_bool(jax.random.key(22), sk.lv0, jnp.asarray(msgs),
                          p.tlwe_lv0.alpha)
    out = proxy_reenc.reencrypt(ct, rk2)
    np.testing.assert_array_equal(
        np.asarray(lwe_decrypt_bool(out, sk_dirty.lv0)), msgs)


def test_cloud_key_mb_roundtrip_full_and_seeded(sk, tmp_path):
    """Multi-bit key material survives both archive forms: the full archive
    stores bsk_mb verbatim; the seeded archive stores only mb bodies + the
    gadget-bearing mask coefficients and replays the masks from
    fold_in(gen_seed, 0x6d62) — bit-exact."""
    from rs_tfhe_tpu.key import CloudKey

    ck = CloudKey.generate(jax.random.key(7), sk, multibit=True)
    for seeded in (False, True):
        p = tmp_path / f"ck_mb_{seeded}.npz"
        save_cloud_key(p, ck, seeded=seeded)
        ck2 = load_cloud_key(p)
        assert ck2.bsk_mb is not None, seeded
        np.testing.assert_array_equal(
            np.asarray(ck.bsk_mb), np.asarray(ck2.bsk_mb)
        )


def test_cloud_key_without_mb_loads_without_mb(sk, ck, tmp_path):
    p = tmp_path / "ck_plain.npz"
    save_cloud_key(p, ck, seeded=True)
    ck2 = load_cloud_key(p)
    assert ck2.bsk_mb is None
