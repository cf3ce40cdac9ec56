"""Noise-budget model vs empirical measurement (new capability — the
reference has no failure detection, SURVEY.md §5)."""

import jax
import jax.numpy as jnp
import numpy as np

import rs_tfhe_tpu as tfhe
from rs_tfhe_tpu import gates
from rs_tfhe_tpu.tlwe import lwe_encrypt_bool
from rs_tfhe_tpu.torus import f64_to_torus
from rs_tfhe_tpu.utils.noise import estimate, measure_phase_noise


def test_estimates_are_sane_for_all_param_sets():
    for name, p in tfhe.ALL_SECURITY_SETS.items():
        est = estimate(p)
        assert 0.0 < est.bootstrap_out_std < 0.5, name
        # the boolean sets must give essentially-always-correct gates; the
        # Uint sets use message-modulus margins, not the boolean 1/16 margin
        # (UINT1's boolean-margin estimate is ~1e-2 — it is a LUT set)
        if name.endswith("_BIT"):
            assert est.gate_fail_prob < 1e-10, (name, est.gate_fail_prob)
        else:
            assert est.gate_fail_prob < 0.5, (name, est.gate_fail_prob)


def test_fresh_noise_matches_alpha(tiny, sk, rng):
    msgs = jnp.asarray(np.ones(512, dtype=bool))
    ct = lwe_encrypt_bool(jax.random.key(0), sk.lv0, msgs, 1e-4)
    noise = measure_phase_noise(ct, sk.lv0, np.uint32(f64_to_torus(0.125)))
    # empirical std within 3x of the sampling alpha (512 samples)
    assert 0.3e-4 < noise.std() < 3e-4


def test_bootstrap_output_noise_within_model(tiny, sk, ck, rng):
    """Empirical post-gate noise must not exceed the analytic bound."""
    est = estimate(tiny)
    bits = jnp.asarray(rng.integers(0, 2, 64).astype(bool))
    a = lwe_encrypt_bool(jax.random.key(1), sk.lv0, bits, tiny.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(jax.random.key(2), sk.lv0, ~bits, tiny.tlwe_lv0.alpha)
    out = gates.nand(a, b, ck)  # NAND(x, ~x) == True always
    noise = measure_phase_noise(out, sk.lv0, np.uint32(f64_to_torus(0.125)))
    assert np.abs(noise).max() < 6.0 * est.bootstrap_out_std + 1e-9
    assert noise.std() < 2.0 * est.bootstrap_out_std + 1e-9


def test_radix_and_nibble_set_margins():
    """Pin the engineered margins (lut_margin, with the CORRECTED 1/(4m)
    decision distance — the early 1/(2m) version was caught by a
    reproducible single-digit failure at exactly the predicted tail):
    RADIX (N=2048) certifies base-8; NIBBLE (N=4096) certifies base-16
    ('8-bit add in 3 PBS', review round 1 item 6) at < 1e-9."""
    from rs_tfhe_tpu.params import (
        SECURITY_128_BIT_FAST,
        SECURITY_128_BIT_NIBBLE,
        SECURITY_128_BIT_RADIX,
    )
    from rs_tfhe_tpu.utils.noise import lut_margin

    s8, p8 = lut_margin(SECURITY_128_BIT_RADIX, 16)
    assert s8 >= 6.0 and p8 < 1e-9, (s8, p8)
    s16r, p16r = lut_margin(SECURITY_128_BIT_RADIX, 32)
    assert 3.0 < s16r < 6.0  # fast set: usable (1e-4) but not certified

    s16, p16 = lut_margin(SECURITY_128_BIT_NIBBLE, 32)
    assert s16 >= 6.0, s16
    assert p16 < 1e-9, p16
    smul, pmul = lut_margin(SECURITY_128_BIT_NIBBLE, 32, 8)  # mul columns
    assert smul >= 6.0 and pmul < 1e-9, (smul, pmul)
    est = estimate(SECURITY_128_BIT_NIBBLE)
    assert est.gate_fail_prob < 1e-30
    # the N=1024 sets genuinely cannot do base 16 — that's why these exist
    s16_fast, _ = lut_margin(SECURITY_128_BIT_FAST, 32)
    assert s16_fast < 3.0


def test_mb_routing_preserves_certified_lut_margins():
    """VERDICT round-4 missing item 1: every certified LUT claim re-derived
    under multi-bit routing. At the certified sets the pair-grouped
    rotation's extra variance is invisible (the rotation term sits 20-100x
    below the keyswitch/modswitch floors), so the margins are unchanged and
    `mb_lut_route_ok` keeps the B<=2 auto-route on; at FAST/strict —
    whose rotation noise dominates — the policy refuses the LUT route
    (gates keep their own published mb margins)."""
    from rs_tfhe_tpu.params import (
        SECURITY_128_BIT,
        SECURITY_128_BIT_FAST,
        SECURITY_128_BIT_NIBBLE,
        SECURITY_128_BIT_RADIX,
    )
    from rs_tfhe_tpu.utils.noise import lut_margin, mb_lut_route_ok

    for p, mod, n in [
        (SECURITY_128_BIT_RADIX, 16, 3),  # certified base-8
        (SECURITY_128_BIT_NIBBLE, 32, 3),  # certified base-16
        (SECURITY_128_BIT_NIBBLE, 32, 8),  # mul_radix columns
    ]:
        assert mb_lut_route_ok(p)
        s_std, p_std = lut_margin(p, mod, n)
        s_mb, p_mb = lut_margin(p, mod, n, mb_group=2)
        assert s_mb >= 0.99 * s_std, (s_std, s_mb)
        assert s_mb >= 6.0 and p_mb < 1e-9, (s_mb, p_mb)
    assert not mb_lut_route_ok(SECURITY_128_BIT_FAST)
    assert not mb_lut_route_ok(SECURITY_128_BIT)


def test_mb_route_policy_gates_bootstrap_with_testvec(monkeypatch, tiny):
    """bootstrap_with_testvec consults mb_lut_route_ok: when the policy
    refuses, a multibit CloudKey's bsk_mb must NOT reach blind_rotate."""
    import rs_tfhe_tpu.bootstrap as bs_mod

    seen = {}

    def fake_blind_rotate(ct, tv, bsk, params, bsk_mb=None):
        seen["mb"] = bsk_mb is not None
        import jax.numpy as jnp2

        return jnp2.zeros((ct.shape[0], 2, params.n1), jnp2.uint32)

    monkeypatch.setattr(bs_mod, "blind_rotate", fake_blind_rotate)

    class FakeCK:
        params = tiny
        bsk = None
        bsk_mb = object()
        ksk_limbs = jnp.zeros(
            (tiny.n1 * tiny.trgsw_lv1.iks_t * (1 << tiny.trgsw_lv1.basebit),
             4 * (-(-(tiny.n0 + 1) // 128) * 128)), jnp.int8)
        testvec = jnp.zeros((2, tiny.n1), jnp.uint32)

    ct = jnp.zeros((1, tiny.n0 + 1), jnp.uint32)
    tv = jnp.zeros((2, tiny.n1), jnp.uint32)

    monkeypatch.setattr(
        "rs_tfhe_tpu.utils.noise.mb_lut_route_ok", lambda p: False
    )
    bs_mod.bootstrap_with_testvec(ct, tv, FakeCK())
    assert seen["mb"] is False
    bs_mod.bootstrap_with_testvec(ct, tv, FakeCK(), allow_mb=True)
    assert seen["mb"] is True
    monkeypatch.setattr(
        "rs_tfhe_tpu.utils.noise.mb_lut_route_ok", lambda p: True
    )
    bs_mod.bootstrap_with_testvec(ct, tv, FakeCK())
    assert seen["mb"] is True
