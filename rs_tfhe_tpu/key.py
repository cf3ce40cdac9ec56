"""Secret and cloud (evaluation) keys as JAX pytrees.

Reference: rs-tfhe key.rs. Differences by design:
  - keys are immutable pytrees, usable directly as jitted-function arguments
    (params ride along as static metadata);
  - the key-switching key is stored pre-limb-split for the one-hot int8
    contraction (ops/keyswitch.py);
  - the bootstrapping key is stored as coefficient polynomials (a few MB);
    each blind-rotation step expands its row into the exact-contraction
    operand on the fly (ops/poly.build_step_matrix) — the analogue of the
    reference's precomputed TRGSWLv1FFT (key.rs:19,124-156);
  - generation is deterministic from an explicit jax.random key (the
    reference uses thread_rng, key.rs:34).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from .params import TORUS_BITS, TfheParams
from .tlwe import lwe_encrypt_rows_limbs
from .torus import f64_to_torus, lane_pad
from .trgsw import trgsw_encrypt_torus


def secure_prng_key() -> jax.Array:
    """A threefry PRNG key seeded from the OS CSPRNG (`os.urandom`).

    SECURITY.md: the library's deterministic seeding is a feature for
    reproducible tests and seeded (compressed) transport, but production
    secret keys must come from kernel entropy. 64 bits of urandom feed
    jax.random.key — the resulting threefry stream is used for key-mask
    material only (the secret bits and noise), never exposed raw."""
    import os

    seed = int.from_bytes(os.urandom(8), "little", signed=True)  # fits int64
    return jax.random.key(seed, impl="threefry2x32")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SecretKey:
    """Binary secret keys (reference key.rs:21-48)."""

    lv0: jax.Array  # uint32 [n0], values in {0, 1}
    lv1: jax.Array  # uint32 [N], values in {0, 1}
    params: TfheParams = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def generate(key: jax.Array, params: TfheParams) -> "SecretKey":
        k0, k1 = jax.random.split(key)
        lv0 = jax.random.bernoulli(k0, 0.5, (params.n0,)).astype(jnp.uint32)
        lv1 = jax.random.bernoulli(k1, 0.5, (params.n1,)).astype(jnp.uint32)
        return SecretKey(lv0=lv0, lv1=lv1, params=params)

    @staticmethod
    def generate_secure(params: TfheParams) -> "SecretKey":
        """Generate from OS CSPRNG entropy (`os.urandom`) — the production
        path SECURITY.md prescribes, packaged so deployments don't hand-roll
        it. Deterministic `generate(jax.random.key(seed), ...)` remains the
        test/replay path; this one draws a fresh 64-bit threefry key from
        the kernel's entropy pool per call."""
        return SecretKey.generate(secure_prng_key(), params)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CloudKey:
    """Evaluation key bundle (reference key.rs:51-75)."""

    testvec: jax.Array  # uint32 [2, N]
    #: planar-padded limb table (tlwe.lwe_encrypt_rows_limbs layout)
    ksk_limbs: jax.Array  # int8 [N*IKS_T*BASE, 4*lane_pad(n0+1)]
    bsk: jax.Array  # uint32 [n0, 2L, 2, N]
    params: TfheParams = dataclasses.field(metadata=dict(static=True))
    #: raw key data of the PRNG key `generate` was called with. The key
    #: masks are pseudorandom streams derived from it, so SEEDED
    #: serialization (utils/serialization.save_cloud_key(seeded=True))
    #: ships only this seed + the ciphertext bodies (~9x smaller files)
    #: and replays the masks at load. Public-randomness only — the secret
    #: key is NOT derivable from it (noise/body already published).
    gen_seed: Optional[jax.Array] = None  # uint32 [2]
    #: multi-bit (grouping factor 2) bootstrapping key: TRGSW encryptions of
    #: the four pair-indicator products per lv0 secret-bit PAIR
    #: (gen_bootstrapping_key_mb). Optional — `generate(multibit=True)`.
    #: Halves the sequential CMUX-chain length of small batches; no
    #: reference analog (the reference rotates bit-by-bit,
    #: trgsw.rs:209-223).
    bsk_mb: Optional[jax.Array] = None  # uint32 [n0/2, 4, 2L, 2, N]

    @staticmethod
    def generate(
        key: jax.Array, sk: SecretKey, multibit: bool = False
    ) -> "CloudKey":
        ksk_limbs, bsk, mb = _generate_jit(key, sk, multibit=multibit)
        return CloudKey(
            testvec=gen_testvec(sk.params),
            ksk_limbs=ksk_limbs,
            bsk=bsk,
            params=sk.params,
            gen_seed=jax.random.key_data(key).astype(jnp.uint32),
            bsk_mb=mb,
        )

    @staticmethod
    def generate_secure(sk: SecretKey, multibit: bool = False) -> "CloudKey":
        """Cloud-key generation seeded from the OS CSPRNG (`secure_prng_key`)
        — the production companion of SecretKey.generate_secure. Seeded
        serialization still works (gen_seed records the drawn key)."""
        return CloudKey.generate(secure_prng_key(), sk, multibit=multibit)

    @staticmethod
    def generate_no_ksk(params: TfheParams) -> "CloudKey":
        """All-zero dummy keys: lets decomposition/external-product/CMUX unit
        tests skip the expensive keygen (reference new_no_ksk, key.rs:68-75)."""
        g = params.trgsw_lv1
        return CloudKey(
            testvec=gen_testvec(params),
            ksk_limbs=jnp.zeros(
                (params.n1 * g.iks_t * params.ks_base,
                 4 * lane_pad(params.n0 + 1)),
                dtype=jnp.int8,
            ),
            bsk=jnp.zeros((params.n0, 2 * g.l, 2, params.n1), dtype=jnp.uint32),
            params=params,
        )


@functools.partial(jax.jit, static_argnames=("multibit",))
def _generate_jit(key: jax.Array, sk: SecretKey, multibit: bool = False):
    """KSK + BSK (+ multi-bit BSK) generation fused into ONE jitted program
    — one device dispatch instead of several (sk's params ride along as
    static pytree metadata)."""
    k_ksk, k_bsk = jax.random.split(key)
    ksk_limbs = gen_key_switching_key(k_ksk, sk)
    bsk = gen_bootstrapping_key(k_bsk, sk)
    mb = None
    if multibit:
        # fold_in keeps the KSK/BSK PRNG streams byte-identical to a
        # non-multibit generation (golden vectors + seeded replay depend
        # on that); 0x6d62 = "mb".
        mb = gen_bootstrapping_key_mb(jax.random.fold_in(key, 0x6D62), sk)
    return ksk_limbs, bsk, mb


def gen_testvec(params: TfheParams) -> jax.Array:
    """Constant test vector: a = 0, b[i] = 1/8 (reference key.rs:91-100)."""
    n = params.n1
    b = jnp.full((n,), jnp.uint32(int(f64_to_torus(0.125))))
    return jnp.stack([jnp.zeros((n,), jnp.uint32), b])


def gen_key_switching_key(key: jax.Array, sk: SecretKey) -> jax.Array:
    """KSK rows encrypt k * s1[i] / 2^((j+1)*basebit) under s0.

    Reference: key.rs:102-122. The plaintexts are the exact integers
    (k*s1[i]) << (32 - (j+1)*basebit); rows with k = 0 are zeroed (the
    reference never writes them), so one-hot selection of k=0 is a no-op.
    Returns the limb-split int8 matrix consumed by ops/keyswitch.py.
    """
    params = sk.params
    g = params.trgsw_lv1
    n1, t, base, bb = params.n1, g.iks_t, params.ks_base, g.basebit

    ks = jnp.arange(base, dtype=jnp.uint32)  # [base]
    shifts = jnp.asarray(
        [TORUS_BITS - (j + 1) * bb for j in range(t)], dtype=jnp.uint32
    )  # [t]
    # mu[i, j, k] = (k * s1[i]) << shift_j
    mu = (ks[None, None, :] * sk.lv1[:, None, None]) << shifts[None, :, None]
    mu_flat = mu.reshape(n1 * t * base)

    # zero the k == 0 rows (reference skips them: key.rs:109-111); the
    # encrypt+zero+limb-split pipeline runs as a scan over row chunks,
    # bit-identical to the monolithic form (tlwe.lwe_encrypt_rows_limbs).
    zero_mask = jnp.tile(jnp.arange(base), n1 * t) == 0
    return lwe_encrypt_rows_limbs(
        key, sk.lv0, mu_flat, params.ksk_alpha, zero_mask=zero_mask
    )


def gen_bootstrapping_key(key: jax.Array, sk: SecretKey) -> jax.Array:
    """TRGSW-encrypt each bit of s0 under s1 (reference key.rs:124-156).

    The reference fans this out over a rayon pool with thread-local FFT plans;
    here the n0 encryptions are one batched tensor op. If the parameter set
    requests BSK rounding (params.bsk_round_bits), the rows are generated as
    reduced-modulus samples — mask on the 2^rb grid, body rounded to it —
    so every consumer (XLA scan, Nussbaumer, serialization) sees the same
    24-bit key, whose lowest limb plane is zero. NOT post-hoc rounding: rounding a full-torus mask after
    encryption would inject an error*secret term amplified ~N/2x (measured
    0.8% gate failures); grid sampling keeps a (*) s exact.
    """
    params = sk.params
    return trgsw_encrypt_torus(
        key, sk.lv1, sk.lv0, params.bsk_alpha, params,
        mask_grid_bits=params.bsk_round_bits,
    )


def gen_bootstrapping_key_mb(key: jax.Array, sk: SecretKey) -> jax.Array:
    """Multi-bit (grouping factor 2) bootstrapping key.

    For each PAIR of lv0 secret bits (s1, s2) = (s[2i], s[2i+1]),
    TRGSW-encrypt the four pair indicators under s_lv1:

        v = (0,0): (1-s1)(1-s2)    v = (1,0): s1(1-s2)
        v = (0,1): (1-s1)s2        v = (1,1): s1*s2

    so that  sum_v X^(a1*v1 + a2*v2) * ind_v = X^(a1*s1 + a2*s2)  and ONE
    external product advances the blind rotation by TWO mask elements
    (ops/blind_rotate.blind_rotate_mb). Returns uint32 [n0/2, 4, 2L, 2, N],
    pattern order [(0,0), (1,0), (0,1), (1,1)].

    Encrypting products of secret bits is the standard multi-bit-PBS
    circular-security assumption (same family as the reference's BSK, which
    encrypts the bits themselves, key.rs:124-156). Noise cost: the combined
    TRGSW sums 4 independent encryptions => 4x BSK-noise variance per step
    at half the steps, 2x per rotation (utils/noise.estimate(mb_group=2)).
    """
    params = sk.params
    assert params.n0 % 2 == 0, "multi-bit grouping needs an even n0"
    s1 = sk.lv0[0::2]
    s2 = sk.lv0[1::2]
    one = jnp.uint32(1)
    inds = jnp.stack(
        [
            (one - s1) * (one - s2),
            s1 * (one - s2),
            (one - s1) * s2,
            s1 * s2,
        ],
        axis=1,
    )  # [n0/2, 4] in {0, 1}
    return trgsw_encrypt_torus(
        key, sk.lv1, inds, params.bsk_alpha, params,
        mask_grid_bits=params.bsk_round_bits,
    )


def round_bsk(bsk: jax.Array, round_bits: int) -> jax.Array:
    """Round every BSK coefficient to 32 - round_bits torus bits (to
    nearest, wrapping). Test helper for reduced-modulus keys — real key
    generation uses grid sampling instead
    (gen_bootstrapping_key), which avoids the mask-rounding-error-times-
    secret term that post-hoc rounding would inject."""
    if round_bits <= 0:
        return bsk
    half = jnp.uint32(1 << (round_bits - 1))
    rb = jnp.uint32(round_bits)
    return ((bsk + half) >> rb) << rb
