"""Key serialization: save/load SecretKey and CloudKey to .npz archives.

The reference has no persistence at all — keys exist only in memory and a
CloudKey takes minutes to generate serially (rs-tfhe key.rs; SURVEY.md §5).
Here keys are flat pytrees of arrays, so checkpoint/resume is a plain
compressed-archive round trip; parameters are stored alongside so a loaded
key reconstructs its exact TfheParams.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from ..key import CloudKey, SecretKey
from ..params import TfheParams, TlweParams, TrgswParams, TrlweParams

#: v2: ksk_limbs moved from interleaved [rows, (n0+1)*4] to planar-padded
#: [rows, 4*lane_pad(n0+1)] (tlwe.lwe_encrypt_rows_limbs layout)
_FORMAT_VERSION = 2


def params_to_dict(params: TfheParams) -> dict:
    return dataclasses.asdict(params)


def params_from_dict(d: dict) -> TfheParams:
    return TfheParams(
        security_bits=d["security_bits"],
        description=d["description"],
        tlwe_lv0=TlweParams(**d["tlwe_lv0"]),
        tlwe_lv1=TlweParams(**d["tlwe_lv1"]),
        trlwe_lv1=TrlweParams(**d["trlwe_lv1"]),
        trgsw_lv1=TrgswParams(**d["trgsw_lv1"]),
        bsk_round_bits=d.get("bsk_round_bits", 0),  # absent in v1 files
    )


def save_secret_key(path, sk: SecretKey) -> None:
    np.savez_compressed(
        path,
        version=_FORMAT_VERSION,
        kind="secret",
        params=json.dumps(params_to_dict(sk.params)),
        lv0=np.asarray(sk.lv0),
        lv1=np.asarray(sk.lv1),
    )


def load_secret_key(path) -> SecretKey:
    with np.load(path, allow_pickle=False) as z:
        _check(z, "secret")
        params = params_from_dict(json.loads(str(z["params"])))
        return SecretKey(
            lv0=jnp.asarray(z["lv0"]), lv1=jnp.asarray(z["lv1"]), params=params
        )


def save_cloud_key(path, ck: CloudKey, seeded: bool = False) -> None:
    """Full: ~100 MB compressed at SECURITY_128_BIT.

    seeded=True stores only the generate-key seed + the ciphertext BODIES
    (~9x smaller): key masks are pseudorandom streams replayed from the
    seed at load (tlwe.lwe_rows_limbs_from_bodies and the BSK mask replay
    below), bit-identical to the original — no security change, the seed
    only ever produced public mask randomness. Requires ck.gen_seed
    (present on generated keys; absent on no-ksk dummies)."""
    mb_extra = (
        {} if ck.bsk_mb is None else {"bsk_mb": np.asarray(ck.bsk_mb)}
    )
    if not seeded:
        np.savez_compressed(
            path,
            version=_FORMAT_VERSION,
            kind="cloud",
            params=json.dumps(params_to_dict(ck.params)),
            testvec=np.asarray(ck.testvec),
            ksk_limbs=np.asarray(ck.ksk_limbs),
            bsk=np.asarray(ck.bsk),
            **mb_extra,
        )
        return
    if ck.gen_seed is None:
        raise ValueError("seeded save needs ck.gen_seed (a generated key)")
    params = ck.params
    l = params.trgsw_lv1.l
    # KSK bodies: recombine the 4 planar int8 limb planes of column n0
    p = _lane_pad(params.n0 + 1)
    limbs = np.asarray(ck.ksk_limbs)
    bodies = np.zeros(limbs.shape[0], dtype=np.uint32)
    for q in range(4):
        plane = limbs[:, q * p + params.n0].astype(np.int32).astype(np.uint32)
        bodies += plane << np.uint32(8 * q)
    if ck.bsk_mb is not None:
        # mb masks replay from fold_in(gen_seed, 0x6d62) exactly like the
        # BSK's; only bodies + the gadget-bearing mask coefficients persist
        mb_extra = {
            "mb_bodies": np.asarray(ck.bsk_mb[:, :, :, 1, :]),
            "mb_mask0": np.asarray(ck.bsk_mb[:, :, :l, 0, 0]),
        }
    np.savez_compressed(
        path,
        version=_FORMAT_VERSION,
        kind="cloud-seeded",
        prng_impl="threefry2x32",
        params=json.dumps(params_to_dict(ck.params)),
        gen_seed=np.asarray(ck.gen_seed),
        ksk_bodies=bodies,
        bsk_bodies=np.asarray(ck.bsk[:, :, 1, :]),
        # gadget constants ride on mask coefficient 0 of the first L rows
        # (trgsw.trgsw_encrypt_torus) — store those mask values verbatim
        bsk_mask0=np.asarray(ck.bsk[:, :l, 0, 0]),
        **mb_extra,
    )


def _lane_pad(n: int, lanes: int = 128) -> int:
    return -(-n // lanes) * lanes


def _rebuild_seeded(z, params: TfheParams):
    """Replay the key masks from the generate seed (save_cloud_key docs)."""
    import jax

    from ..tlwe import lwe_rows_limbs_from_bodies

    if str(z["prng_impl"]) != "threefry2x32":
        raise ValueError(f"unsupported prng_impl {z['prng_impl']}")
    g = params.trgsw_lv1
    key = jax.random.wrap_key_data(jnp.asarray(z["gen_seed"]))
    k_ksk, k_bsk = jax.random.split(key)

    # KSK: masks are the threefry stream of k_ksk's first split; the k = 0
    # rows were zeroed at generation (key.gen_key_switching_key) —
    # structural, so re-derived from params
    k_mask_ksk, _ = jax.random.split(k_ksk)
    zero_mask = jnp.tile(jnp.arange(params.ks_base), params.n1 * g.iks_t) == 0
    ksk_limbs = lwe_rows_limbs_from_bodies(
        k_mask_ksk, jnp.asarray(z["ksk_bodies"]), params.n0,
        zero_mask=zero_mask,
    )

    # BSK: masks are uniform bits of k_bsk's first split (grid-clamped for
    # reduced-modulus keys), with the gadget constants restored on
    # coefficient 0 of the first L rows (stored verbatim)
    k_mask_bsk, _ = jax.random.split(k_bsk)
    bodies = jnp.asarray(z["bsk_bodies"])
    a = jax.random.bits(k_mask_bsk, bodies.shape, dtype=jnp.uint32)
    if params.bsk_round_bits > 0:
        rb = jnp.uint32(params.bsk_round_bits)
        a = (a >> rb) << rb
    a = a.at[:, : g.l, 0].set(jnp.asarray(z["bsk_mask0"]))
    bsk = jnp.stack([a, bodies], axis=2)  # [n0, 2L, 2, N]

    bsk_mb = None
    if "mb_bodies" in z.files:
        k_mask_mb, _ = jax.random.split(jax.random.fold_in(key, 0x6D62))
        mb_bodies = jnp.asarray(z["mb_bodies"])  # [G, 4, 2L, N]
        am = jax.random.bits(k_mask_mb, mb_bodies.shape, dtype=jnp.uint32)
        if params.bsk_round_bits > 0:
            rb = jnp.uint32(params.bsk_round_bits)
            am = (am >> rb) << rb
        am = am.at[:, :, : g.l, 0].set(jnp.asarray(z["mb_mask0"]))
        bsk_mb = jnp.stack([am, mb_bodies], axis=3)  # [G, 4, 2L, 2, N]
    return ksk_limbs, bsk, bsk_mb


def load_cloud_key(path) -> CloudKey:
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        _check(z, kind if kind == "cloud-seeded" else "cloud")
        params = params_from_dict(json.loads(str(z["params"])))
        from ..key import gen_testvec

        if kind == "cloud-seeded":
            ksk_limbs, bsk, bsk_mb = _rebuild_seeded(z, params)
            testvec = gen_testvec(params)
            gen_seed = jnp.asarray(z["gen_seed"])
        else:
            ksk_limbs = jnp.asarray(z["ksk_limbs"])
            bsk = jnp.asarray(z["bsk"])
            bsk_mb = jnp.asarray(z["bsk_mb"]) if "bsk_mb" in z.files else None
            testvec = jnp.asarray(z["testvec"])
            gen_seed = None

        return CloudKey(
            testvec=testvec,
            ksk_limbs=ksk_limbs,
            bsk=bsk,
            params=params,
            gen_seed=gen_seed,
            bsk_mb=bsk_mb,
        )


def save_reenc_key(path, rk) -> None:
    """Persist a proxy re-encryption key (no reference analogue — rs-tfhe
    has no persistence at all; re-keys are the natural transport item in a
    proxy deployment: generated once by the delegator, shipped to the
    evaluation server)."""
    np.savez_compressed(
        path,
        version=_FORMAT_VERSION,
        kind="reenc",
        params=json.dumps(params_to_dict(rk.params)),
        table_limbs=np.asarray(rk.table_limbs),
        basebit=rk.basebit,
        t=rk.t,
    )


def load_reenc_key(path):
    from ..proxy_reenc import ProxyReencryptionKey

    with np.load(path, allow_pickle=False) as z:
        _check(z, "reenc")
        return ProxyReencryptionKey(
            table_limbs=jnp.asarray(z["table_limbs"]),
            basebit=int(z["basebit"]),
            t=int(z["t"]),
            params=params_from_dict(json.loads(str(z["params"]))),
        )


def _check(z, kind: str) -> None:
    v = int(z["version"])
    if v != _FORMAT_VERSION:
        raise ValueError(f"unsupported key format version {v}")
    if str(z["kind"]) != kind:
        raise ValueError(f"expected a {kind} key, found {z['kind']}")
