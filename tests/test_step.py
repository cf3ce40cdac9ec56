"""The blind-rotation step on the XLA path: the exact int8 contraction
against the schoolbook oracle, its operand layout, the bf16 alternative, the
multi-bit chain against the standard one, and step_impl validation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rs_tfhe_tpu.config as C
from rs_tfhe_tpu import tlwe
from rs_tfhe_tpu.key import CloudKey, round_bsk
from rs_tfhe_tpu.ops import poly
from rs_tfhe_tpu.ops.blind_rotate import blind_rotate, blind_rotate_mb
from rs_tfhe_tpu.trlwe import trlwe_phase


def _schoolbook_step(d, t):
    """out[b, o] = sum_j d[b, j] (*) t[j, o] via the host oracle."""
    batch, j_rows, n = d.shape
    o_rows = t.shape[1]
    out = np.zeros((batch, o_rows, n), np.uint32)
    for b in range(batch):
        for o in range(o_rows):
            for j in range(j_rows):
                with np.errstate(over="ignore"):
                    out[b, o] += poly.schoolbook_negacyclic(
                        d[b, j].astype(np.int64).astype(np.uint32), t[j, o])
    return out


@pytest.mark.parametrize(
    "n, j_rows, batch, d_limbs",
    [(32, 2, 1, 1), (64, 4, 3, 1), (64, 6, 2, 1), (128, 4, 1, 1),
     (32, 2, 2, 2), (64, 2, 1, 3), (128, 6, 3, 1), (16, 4, 5, 2)],
)
def test_xla_step_matches_schoolbook(rng, n, j_rows, batch, d_limbs):
    """build_step_matrix + polymul_small_by_torus_multi == schoolbook, over
    ring size, gadget rows, batch and digit limbs."""
    half = 1 << (8 * d_limbs - 2) if d_limbs > 1 else 128
    d = rng.integers(-half, half, (batch, j_rows, n)).astype(np.int32)
    t = rng.integers(0, 1 << 32, (j_rows, 2, n), dtype=np.uint32)
    got = poly.polymul_small_by_torus_multi(
        jnp.asarray(d), poly.build_step_matrix(jnp.asarray(t)), d_limbs, 2)
    np.testing.assert_array_equal(np.asarray(got), _schoolbook_step(d, t))


@pytest.mark.parametrize("o_rows", [1, 2])
def test_step_matrix_layout(rng, o_rows):
    """Row (o, q, c), column (j, m) holds torus limb q of
    t_ext[j, o, (c - m) mod 2N]: one 2-D operand, contraction axis minor."""
    from rs_tfhe_tpu.torus import split_u32_limbs

    j_rows, n = 3, 16
    t = rng.integers(0, 1 << 32, (j_rows, o_rows, n), dtype=np.uint32)
    mat = np.asarray(poly.build_step_matrix(jnp.asarray(t)))
    assert mat.shape == (o_rows * 4 * n, j_rows * n) and mat.dtype == np.int8
    ext = np.concatenate([t, (np.uint32(0) - t)], axis=-1)  # [J, O, 2N]
    limbs = np.asarray(split_u32_limbs(jnp.asarray(ext)))  # [J, O, 2N, 4]
    for o, q, c, j, m in [(0, 0, 0, 0, 0), (o_rows - 1, 3, 5, 2, 9),
                          (0, 1, 15, 1, 15), (o_rows - 1, 2, 3, 0, 12)]:
        assert mat[(o * 4 + q) * n + c, j * n + m] == \
            limbs[j, o, (c - m) % (2 * n), q]


@pytest.mark.parametrize("n, j_rows", [(64, 6), (1024, 1)])
def test_bf16_step_matches_int8(rng, n, j_rows):
    """dot_impl="bf16" (float32 accumulation over chunks of <= 1024) is
    bit-exact against the int8 contraction."""
    d = jnp.asarray(rng.integers(-128, 128, (3, j_rows, n)), jnp.int32)
    t = jnp.asarray(rng.integers(0, 1 << 32, (j_rows, 2, n), dtype=np.uint32))
    ref = poly.polymul_small_by_torus_multi(d, poly.build_step_matrix(t), 1, 2)
    old = C.config.dot_impl
    try:
        C.config.dot_impl = "bf16"
        got = poly.polymul_small_by_torus_multi(
            d, poly.build_step_matrix(t), 1, 2)
    finally:
        C.config.dot_impl = old
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize(
    "impl",
    ["pallas", "fused", "fused_small", "fused_small_mb", "fused_wide",
     "fused_tile"],
)
def test_removed_step_impl_raises(tiny, ck, impl):
    """Step implementations that no longer exist raise; nothing falls back
    to another path."""
    ct = jnp.zeros((2, tiny.n0 + 1), jnp.uint32)
    old = C.config.step_impl
    try:
        C.config.step_impl = impl
        with pytest.raises(ValueError, match="step_impl"):
            blind_rotate(ct, ck.testvec, ck.bsk, tiny)
    finally:
        C.config.step_impl = old


def test_cloudkey_carries_no_derived_layouts(ck):
    """The evaluation key is the BSK, the KSK limb table, the test vector,
    the generation seed and the optional multi-bit BSK: nothing derived."""
    import dataclasses

    assert [f.name for f in dataclasses.fields(CloudKey)] == [
        "testvec", "ksk_limbs", "bsk", "params", "gen_seed", "bsk_mb"]
    assert ck.bsk_mb is None


@pytest.fixture(scope="module")
def ck_mb(sk):
    return CloudKey.generate(jax.random.key(7), sk, multibit=True)


@pytest.mark.parametrize("rounded", [False, True])
@pytest.mark.parametrize("per_ct_tv", [False, True])
def test_mb_chain_matches_standard_chain(tiny, sk, ck_mb, rng, rounded,
                                         per_ct_tv):
    """blind_rotate_mb (n0/2 grouped steps) lands on the same rotated test
    vector as the standard n0-step chain — with a reduced-modulus (rounded)
    key and with per-ciphertext test vectors. Only the noise differs."""
    bsk, bsk_mb = ck_mb.bsk, ck_mb.bsk_mb
    if rounded:
        bsk, bsk_mb = round_bsk(bsk, 8), round_bsk(bsk_mb, 8)
    batch = 3
    ct = tlwe.lwe_encrypt_bool(
        jax.random.key(11), sk.lv0,
        jnp.asarray(rng.integers(0, 2, batch).astype(bool)),
        tiny.tlwe_lv0.alpha)
    tv = ck_mb.testvec
    if per_ct_tv:
        scale = jnp.asarray([1, 2, 3], jnp.uint32)[:, None, None]
        tv = jnp.broadcast_to(tv, (batch, 2, tiny.n1)) * scale
    acc_std = blind_rotate(ct, tv, bsk, tiny)
    acc_mb = blind_rotate_mb(ct, tv, bsk_mb, tiny)
    ph_std = np.asarray(trlwe_phase(acc_std, sk.lv1)).astype(np.int64)
    ph_mb = np.asarray(trlwe_phase(acc_mb, sk.lv1)).astype(np.int64)
    diff = (ph_mb - ph_std) % (1 << 32)
    diff = np.minimum(diff, (1 << 32) - diff)
    assert diff.max() < (1 << 32) / 64


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [8, 4096])
def test_step_contraction_is_a_gemm_on_gpu(gpu_device, batch):
    """On the card, XLA hands the step's s8 x s8 -> s32 contraction to a GEMM
    (cuBLAS or its Triton GEMM emitter), never a loop."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    from rs_tfhe_tpu import SECURITY_128_BIT_FAST as p

    j_rows = 2 * p.trgsw_lv1.l
    d = jax.ShapeDtypeStruct((batch, j_rows, p.n1), jnp.int32)
    t = jax.ShapeDtypeStruct((j_rows, 2, p.n1), jnp.uint32)
    step = jax.jit(lambda d, t: poly.polymul_small_by_torus_multi(
        d, poly.build_step_matrix(t), 1, 2))
    with jax.default_device(gpu_device):
        hlo = step.lower(d, t).compile().as_text()
    lowered = chip_smoke.contraction_lowerings(hlo)
    assert lowered
    assert not any(chip_smoke.is_loop_lowering(how) for how, _, _ in lowered)
