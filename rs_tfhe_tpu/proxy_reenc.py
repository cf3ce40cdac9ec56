"""LWE proxy re-encryption: re-key ciphertexts Alice -> Bob without decryption.

Reference: rs-tfhe proxy_reenc.rs. Both modes are provided:
  - symmetric (both secret keys available, e.g. key rotation);
  - asymmetric (delegatee public key only; the public key is 2n encryptions
    of zero, public-key encryption is a random +/- subset sum + fresh noise).

Re-encryption itself is the same digit-decompose-and-subtract shape as
identity key switching and reuses the one-hot int8 contraction
(ops/keyswitch.digit_select_subtract) — batched over ciphertexts.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .key import SecretKey
from .ops.keyswitch import digit_select_subtract
from .ops.poly import exact_dot_i8
from .params import TORUS_BITS, TfheParams
from .tlwe import lwe_encrypt_rows_limbs, lwe_encrypt_torus
from .torus import (
    f64_to_torus,
    gaussian_torus,
    planar_limb_table,
    recombine_planar,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PublicKeyLv0:
    """2n encryptions of zero under the owner's lv0 key, pre-limb-split for
    exact subset-sum matmuls (reference proxy_reenc.rs:95-153)."""

    encryptions: jax.Array  # uint32 [size, n0+1]
    #: planar-padded layout (tlwe.lwe_encrypt_rows_limbs contract)
    limbs: jax.Array  # int8 [size, 4*lane_pad(n0+1)]
    params: TfheParams = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def generate(
        key: jax.Array,
        sk_lv0: jax.Array,
        params: TfheParams,
        size: int | None = None,
        alpha: float | None = None,
    ) -> "PublicKeyLv0":
        size = 2 * params.n0 if size is None else size
        alpha = params.tlwe_lv0.alpha if alpha is None else alpha
        zeros = jnp.zeros((size,), dtype=jnp.uint32)
        enc = lwe_encrypt_torus(key, sk_lv0, zeros, alpha)
        return PublicKeyLv0(
            encryptions=enc, limbs=planar_limb_table(enc), params=params
        )

    def encrypt_torus(self, key: jax.Array, mu: jax.Array, alpha: float) -> jax.Array:
        """Public-key encrypt torus messages mu (uint32 [...]).

        Random +/- subset sum of the zero encryptions plus fresh body noise
        (reference proxy_reenc.rs:168-200): each row participates with
        coefficient c in {0, +1, -1}, P(0)=1/2, P(+1)=P(-1)=1/4.
        """
        size = self.encryptions.shape[0]
        k_sel, k_sign, k_noise = jax.random.split(key, 3)
        include = jax.random.bernoulli(k_sel, 0.5, (*mu.shape, size))
        sign = jax.random.bernoulli(k_sign, 0.5, (*mu.shape, size))
        coeff = jnp.where(
            include, jnp.where(sign, jnp.int8(1), jnp.int8(-1)), jnp.int8(0)
        )
        acc = exact_dot_i8(coeff, self.limbs)  # [..., 4*P] int32
        p = self.limbs.shape[-1] // 4
        acc = acc.reshape(*acc.shape[:-1], 4, p)
        combo = recombine_planar(acc)[..., : self.params.n0 + 1]
        noise = gaussian_torus(k_noise, alpha, mu.shape)
        return combo.at[..., -1].add(mu + noise)

    def encrypt_bool(self, key: jax.Array, msg: jax.Array, alpha: float) -> jax.Array:
        mu_true = jnp.uint32(int(f64_to_torus(0.125)))
        mu_false = jnp.uint32(int(f64_to_torus(-0.125)))
        mu = jnp.where(jnp.asarray(msg), mu_true, mu_false)
        return self.encrypt_torus(key, mu, alpha)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ProxyReencryptionKey:
    """Decomposed encryptions of the source key under the target key
    (reference proxy_reenc.rs:224-421), stored limb-split for the int8 contraction."""

    #: planar-padded layout (tlwe.lwe_encrypt_rows_limbs contract)
    table_limbs: jax.Array  # int8 [n0 * t * base, 4*lane_pad(n0+1)]
    basebit: int = dataclasses.field(metadata=dict(static=True))
    t: int = dataclasses.field(metadata=dict(static=True))
    params: TfheParams = dataclasses.field(metadata=dict(static=True))

    @property
    def base(self) -> int:
        return 1 << self.basebit


def _reenc_plaintexts(key_from: jax.Array, params: TfheParams, basebit: int, t: int):
    """mu[i, j, k] = (k * key_from[i]) << (32 - (j+1)*basebit), k=0 rows zero.

    Exact-integer equivalent of the reference's f64 formula
    (proxy_reenc.rs:313, :408).
    """
    base = 1 << basebit
    ks = jnp.arange(base, dtype=jnp.uint32)
    shifts = jnp.asarray(
        [TORUS_BITS - (j + 1) * basebit for j in range(t)], dtype=jnp.uint32
    )
    mu = (ks[None, None, :] * key_from[:, None, None]) << shifts[None, :, None]
    return mu.reshape(params.n0 * t * base)


def _finish_key(rows: jax.Array, params: TfheParams, basebit: int, t: int):
    base = 1 << basebit
    k_idx = jnp.tile(jnp.arange(base), params.n0 * t)
    rows = jnp.where((k_idx == 0)[:, None], jnp.uint32(0), rows)
    return ProxyReencryptionKey(
        table_limbs=planar_limb_table(rows), basebit=basebit, t=t,
        params=params
    )


def new_symmetric(
    key: jax.Array,
    key_from: jax.Array,
    key_to: jax.Array,
    params: TfheParams,
    alpha: float | None = None,
    basebit: int | None = None,
    t: int | None = None,
) -> ProxyReencryptionKey:
    """Both secret keys available (reference proxy_reenc.rs:362-420)."""
    g = params.trgsw_lv1
    alpha = params.ksk_alpha if alpha is None else alpha
    basebit = g.basebit if basebit is None else basebit
    t = g.iks_t if t is None else t
    mu = _reenc_plaintexts(key_from, params, basebit, t)
    # chunked-scan pipeline: bit-identical to lwe_encrypt_torus + zero +
    # limb split, but compiles in seconds at production table shapes
    # (tlwe.lwe_encrypt_rows_limbs)
    base = 1 << basebit
    zero_mask = jnp.tile(jnp.arange(base), params.n0 * t) == 0
    limbs = lwe_encrypt_rows_limbs(key, key_to, mu, alpha, zero_mask=zero_mask)
    return ProxyReencryptionKey(
        table_limbs=limbs, basebit=basebit, t=t, params=params
    )


def new_asymmetric(
    key: jax.Array,
    key_from: jax.Array,
    public_key_to: PublicKeyLv0,
    params: TfheParams,
    alpha: float | None = None,
    basebit: int | None = None,
    t: int | None = None,
) -> ProxyReencryptionKey:
    """Delegatee contributes only a public key (reference proxy_reenc.rs:271-326)."""
    g = params.trgsw_lv1
    alpha = params.ksk_alpha if alpha is None else alpha
    basebit = g.basebit if basebit is None else basebit
    t = g.iks_t if t is None else t
    mu = _reenc_plaintexts(key_from, params, basebit, t)
    rows = public_key_to.encrypt_torus(key, mu, alpha)
    return _finish_key(rows, params, basebit, t)


@jax.jit
def reencrypt(ct: jax.Array, rk: ProxyReencryptionKey) -> jax.Array:
    """Re-encrypt lv0 LWE batches [..., n0+1] from the source key to the
    target key (reference proxy_reenc.rs:468-509)."""
    n0 = rk.params.n0
    return digit_select_subtract(
        ct[..., :n0], ct[..., n0], rk.table_limbs, rk.t, rk.basebit, n0 + 1
    )


# Convenience aliases mirroring the reference free-function names
reencrypt_tlwe_lv0 = reencrypt


def generate_keys_for_test(key: jax.Array, params: TfheParams):
    """Helper: (alice_sk, bob_sk, bob_pk) for examples/tests."""
    k1, k2, k3 = jax.random.split(key, 3)
    alice = SecretKey.generate(k1, params)
    bob = SecretKey.generate(k2, params)
    bob_pk = PublicKeyLv0.generate(k3, bob.lv0, params)
    return alice, bob, bob_pk
