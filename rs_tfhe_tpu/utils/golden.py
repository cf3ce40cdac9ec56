"""Production-parameter golden stages.

Fixed-seed runs of the normal entry points at SECURITY_128_BIT,
SECURITY_UINT4 and SECURITY_128_BIT_NIBBLE whose ciphertext outputs are
pinned in tests/vectors/golden_production.npz (mirroring the reference's
FFT vector discipline, fft/mod.rs:136-159). Every server-side operation is
integer arithmetic mod 2^32 and every input comes from the jax.random seeds
below, so a rerun must reproduce each stored array bit for bit.

Beside each stage the file holds, per parameter-set group, a SHA-256
digest of the sampled material (keys and input ciphertexts: the only
float arithmetic, the noise sampling). An output that differs while the
digest matches is an evaluation difference; with a different digest the
difference entered in sampling.

`chip_smoke.py` compares against the file; `scripts/gen_golden_vectors.py
--production` rewrites it.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

#: tests/vectors/golden_production.npz in a checkout
GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "vectors", "golden_production.npz",
)

#: stage name -> parameter-set group; groups share one keygen
STAGES = {
    "nand_128": "strict",
    "mux_128": "strict",
    "pbs_square_128": "strict",
    "radix_add_128": "strict",
    "kogge_stone_128": "strict",
    "pbs_uint4": "uint4",
    "nibble_add": "nibble",
    "mul_radix_nibble": "nibble",
}


class Stage(NamedTuple):
    name: str
    out: np.ndarray  # the pinned ciphertext batch
    correct: bool  # decrypts to the plain result


class Group(NamedTuple):
    sampled: np.ndarray  # uint8 [32] digest of keys + input ciphertexts
    stages: list


def digest_key(group: str) -> str:
    """The file entry holding a group's sampled-material digest."""
    return f"sampled_{group}"


class Inputs(NamedTuple):
    a_bits: np.ndarray
    b_bits: np.ndarray
    c_bits: np.ndarray
    nib_x: np.ndarray
    nib_y: np.ndarray
    mul_x: np.ndarray
    mul_y: np.ndarray


def stage_inputs() -> Inputs:
    """Plaintexts, drawn in the order of the original capture (which also
    drew two RADIX-set batches of 256 between the boolean and nibble
    stages)."""
    rng = np.random.default_rng(0)
    a_bits = rng.integers(0, 2, 64).astype(bool)
    b_bits = rng.integers(0, 2, 64).astype(bool)
    c_bits = rng.integers(0, 2, 64).astype(bool)
    rng.integers(0, 512, 256)
    rng.integers(0, 512, 256)
    nib_x = rng.integers(0, 256, 256)
    nib_y = rng.integers(0, 256, 256)
    mul_x = rng.integers(0, 256, 32)
    mul_y = rng.integers(0, 256, 32)
    return Inputs(a_bits, b_bits, c_bits, nib_x, nib_y, mul_x, mul_y)


def _host(x) -> np.ndarray:
    return np.asarray(jax.device_get(x))


def _digest(*trees) -> np.ndarray:
    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(trees):
        h.update(_host(leaf).tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def strict_stages() -> Group:
    """Boolean gates, MUX, a LUT and two adders at SECURITY_128_BIT."""
    from .. import SECURITY_128_BIT, gates, models, tlwe
    from ..bit_utils import decrypt_uint, encrypt_uint
    from ..bootstrap import LutBootstrap
    from ..key import CloudKey, SecretKey

    p = SECURITY_128_BIT
    alpha = p.tlwe_lv0.alpha
    inp = stage_inputs()
    m = 8
    x, y = 40590, 27063
    sk = SecretKey.generate(jax.random.key(42), p)
    ck = CloudKey.generate(jax.random.key(7), sk)
    ka, kb, kc = jax.random.split(jax.random.key(3), 3)
    a = tlwe.lwe_encrypt_bool(ka, sk.lv0, jnp.asarray(inp.a_bits), alpha)
    b = tlwe.lwe_encrypt_bool(kb, sk.lv0, jnp.asarray(inp.b_bits), alpha)
    c = tlwe.lwe_encrypt_bool(kc, sk.lv0, jnp.asarray(inp.c_bits), alpha)
    ct = tlwe.lwe_encrypt_message(
        jax.random.key(5), sk.lv0, jnp.asarray(np.arange(m)), m, alpha)
    ra = models.encrypt_radix(jax.random.key(6), sk.lv0, 137, 3, p, 3)
    rb = models.encrypt_radix(jax.random.key(7), sk.lv0, 205, 3, p, 3)
    ea = encrypt_uint(jax.random.key(8), sk.lv0, x, 16, alpha)
    eb = encrypt_uint(jax.random.key(9), sk.lv0, y, 16, alpha)
    sampled = _digest(sk, ck, a, b, c, ct, ra, rb, ea, eb)

    def dec_bool(ct):
        return _host(tlwe.lwe_decrypt_bool(ct, sk.lv0))

    out = []
    nand = gates.batch_gate("nand", a, b, ck)
    out.append(Stage("nand_128", _host(nand),
                     bool((dec_bool(nand) == ~(inp.a_bits & inp.b_bits)).all())))
    mux = gates.mux(a, b, c, ck)
    out.append(Stage("mux_128", _host(mux), bool(
        (dec_bool(mux) == np.where(inp.a_bits, inp.b_bits, inp.c_bits)).all())))

    sq = LutBootstrap().bootstrap_func(ct, lambda x: (x * x) % m, m, ck)
    out.append(Stage("pbs_square_128", _host(sq), bool(
        list(_host(tlwe.lwe_decrypt_message(sq, sk.lv0, m)))
        == [(x * x) % m for x in range(m)])))

    rsum = models.add_radix(ra, rb, ck, 3)
    out.append(Stage("radix_add_128", _host(rsum), bool(
        int(models.decrypt_radix(rsum, sk.lv0, 3)) == (137 + 205) % 512)))

    es = models.add_kogge_stone(ea, eb, ck)
    out.append(Stage("kogge_stone_128", _host(es),
                     bool(decrypt_uint(es, sk.lv0) == (x + y) % 65536)))
    return Group(sampled, out)


def uint4_stages() -> Group:
    """A 3-limb-digit programmable bootstrap at SECURITY_UINT4."""
    from .. import SECURITY_UINT4, tlwe
    from ..bootstrap import LutBootstrap
    from ..key import CloudKey, SecretKey

    p4 = SECURITY_UINT4
    m = 16
    sk4 = SecretKey.generate(jax.random.key(20), p4)
    ck4 = CloudKey.generate(jax.random.key(21), sk4)
    ct4 = tlwe.lwe_encrypt_message(
        jax.random.key(22), sk4.lv0, jnp.asarray(np.arange(m)), m,
        p4.tlwe_lv0.alpha)
    sampled = _digest(sk4, ck4, ct4)
    out4 = LutBootstrap().bootstrap_func(ct4, lambda x: (x * 3 + 1) % m, m, ck4)
    return Group(sampled, [Stage("pbs_uint4", _host(out4), bool(
        list(_host(tlwe.lwe_decrypt_message(out4, sk4.lv0, m)))
        == [(x * 3 + 1) % m for x in range(m)]))])


def nibble_stages() -> Group:
    """The certified N=4096 nibble add (256 trials) and 8x8-bit multiply
    (32 trials) at SECURITY_128_BIT_NIBBLE."""
    from .. import SECURITY_128_BIT_NIBBLE, models
    from ..key import CloudKey, SecretKey

    pn = SECURITY_128_BIT_NIBBLE
    inp = stage_inputs()
    skn = SecretKey.generate(jax.random.key(36), pn)
    ckn = CloudKey.generate(jax.random.key(37), skn)
    na = models.encrypt_radix(jax.random.key(38), skn.lv0, inp.nib_x, 2, pn,
                              base_bits=4)
    nb = models.encrypt_radix(jax.random.key(39), skn.lv0, inp.nib_y, 2, pn,
                              base_bits=4)
    ma = models.encrypt_radix(jax.random.key(40), skn.lv0, inp.mul_x, 4, pn,
                              base_bits=2)
    mb = models.encrypt_radix(jax.random.key(41), skn.lv0, inp.mul_y, 4, pn,
                              base_bits=2)
    sampled = _digest(skn, ckn, na, nb, ma, mb)
    nsum = models.add_radix(na, nb, ckn, base_bits=4)
    dec = _host(models.decrypt_radix(nsum, skn.lv0, base_bits=4))
    out = [Stage("nibble_add", _host(nsum),
                 bool((dec == (inp.nib_x + inp.nib_y) % 256).all()))]
    mprod = models.mul_radix(ma, mb, ckn, base_bits=2)
    mdec = _host(models.decrypt_radix(mprod, skn.lv0, base_bits=2))
    out.append(Stage("mul_radix_nibble", _host(mprod),
                     bool((mdec == inp.mul_x * inp.mul_y).all())))
    return Group(sampled, out)


GROUPS = {"strict": strict_stages, "uint4": uint4_stages, "nibble": nibble_stages}
