"""Direct hardware measurement of multi-bit bootstrap output noise.

The multi-bit key's margin rests on a MODEL (utils.noise.estimate(
mb_group=2), 7.4 sigma at FAST). This script applies the reference's
statistical-test discipline (tlwe.rs:281-304) to the mb key type: run thousands of
independent B=2 NAND bootstraps through the pair-grouped chain (the exact
auto-routed production path), measure the LWE phase noise of the outputs
against the expected +/-1/8 plateau, and compare the std to the model.

The standard-key path is measured by the same harness as a control (it was
cross-validated in round 2: 3.45e-3 measured vs 3.7e-3 model at FAST).

    python scripts/measure_mb_noise.py                 # FAST + strict
    python scripts/measure_mb_noise.py --quick         # FAST only, fewer samples

Writes chiprun_out/mb_noise.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import zlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu.utils.cache import enable_compile_cache  # noqa: E402

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
else:
    enable_compile_cache()

import rs_tfhe_tpu as tfhe  # noqa: E402
from rs_tfhe_tpu import gates, tlwe  # noqa: E402
from rs_tfhe_tpu.torus import f64_to_torus  # noqa: E402
from rs_tfhe_tpu.utils.noise import estimate, measure_phase_noise  # noqa: E402


def measure_set(pname: str, k_iters: int, multibit: bool, sk, ck) -> dict:
    """K independent B=2 NAND bootstraps in ONE dispatch (lax.scan over the
    gate — batch 2 is static, so the multi-bit routing decision holds
    inside the scan exactly as in production)."""
    p = sk.params
    rng = np.random.default_rng(zlib.crc32(pname.encode()) ^ int(multibit))
    a_bits = rng.integers(0, 2, (k_iters, 2)).astype(bool)
    b_bits = rng.integers(0, 2, (k_iters, 2)).astype(bool)
    a = tlwe.lwe_encrypt_bool(jax.random.key(11), sk.lv0,
                              jnp.asarray(a_bits), p.tlwe_lv0.alpha)
    b = tlwe.lwe_encrypt_bool(jax.random.key(12), sk.lv0,
                              jnp.asarray(b_bits), p.tlwe_lv0.alpha)

    @jax.jit
    def run(a_all, b_all, key):
        def step(_, xs):
            x, y = xs
            return None, gates.nand(x, y, key)

        _, outs = jax.lax.scan(step, None, (a_all, b_all))
        return outs

    t0 = time.perf_counter()
    outs = run(a, b, ck)
    outs = np.asarray(jax.device_get(outs)).reshape(-1, p.n0 + 1)
    wall = time.perf_counter() - t0

    want = ~(a_bits & b_bits)  # NAND truth
    mu = int(f64_to_torus(0.125))
    mu_all = np.where(want.reshape(-1), np.uint32(mu),
                      np.uint32((1 << 32) - mu))
    noise = measure_phase_noise(outs, sk.lv0, mu_all)

    dec = np.asarray(tlwe.lwe_decrypt_bool(jnp.asarray(outs), sk.lv0))
    errors = int((dec != want.reshape(-1)).sum())

    est = estimate(p, mb_group=2 if multibit else 1)
    meas_std = float(noise.std())
    model_std = est.bootstrap_out_std
    margin_meas = (1.0 / 16.0) / float(
        np.sqrt(2 * meas_std**2
                + (p.n0 + 1) * (1.0 / (2.0 * p.n1)) ** 2 / 12.0))
    row = {
        "params": pname,
        "multibit": multibit,
        "samples": int(noise.size),
        "gate_errors": errors,
        "measured_std": meas_std,
        "model_std": model_std,
        "ratio": meas_std / model_std,
        "abs_max": float(np.abs(noise).max()),
        "gate_margin_sigmas_measured": margin_meas,
        "wall_s": wall,
    }
    print(f"  {pname} mb={multibit}: std {meas_std:.3e} vs model "
          f"{model_std:.3e} (ratio {row['ratio']:.2f}), "
          f"|max| {row['abs_max']:.3e}, errors {errors}/{noise.size}, "
          f"measured gate margin {margin_meas:.1f} sigma  [{wall:.1f}s]",
          flush=True)
    return row


def main():
    quick = "--quick" in sys.argv
    k_iters = 256 if quick else 2048  # x2 samples per iter (B=2)
    sets = ["SECURITY_128_BIT_FAST"] if quick else [
        "SECURITY_128_BIT_FAST", "SECURITY_128_BIT"]
    print(f"device: {jax.devices()[0]}  iters/set: {k_iters}")
    rows = []
    for pname in sets:
        p = tfhe.ALL_SECURITY_SETS[pname]
        sk = tfhe.SecretKey.generate(jax.random.key(42), p)
        ck_mb = tfhe.CloudKey.generate(jax.random.key(7), sk, multibit=True)
        rows.append(measure_set(pname, k_iters, True, sk, ck_mb))
        # control: same harness, standard routing (validated round 2)
        ck = tfhe.CloudKey.generate(jax.random.key(7), sk)
        rows.append(measure_set(pname, max(k_iters // 4, 128), False, sk, ck))
        del ck_mb, ck

    out = {"device": str(jax.devices()[0]), "rows": rows}
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out", "mb_noise.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    for r in rows:
        if r["multibit"]:
            assert 0.5 <= r["ratio"] <= 1.15, (
                f"mb measured/model std ratio {r['ratio']:.2f} out of "
                "[0.5, 1.15] — model must be conservative but not wildly so")
    print("MB-NOISE-OK")


if __name__ == "__main__":
    main()
