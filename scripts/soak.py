"""Reliability soak on a GPU: decrypt EVERY output, count errors (expect 0).

The p_fail figures (SECURITY_128_BIT_FAST ~3e-19/gate model;
SECURITY_128_BIT_NIBBLE < 1e-9/PBS model) rest on the noise model
(utils/noise.py); this script buys evidence for them: ~10^7 bootstrapped
gates at FAST, ~10^7 at the literal SECURITY_128_BIT reference set, >= 10^4
nibble adds (3 PBS each) at NIBBLE, and >= 10^6 multi-bit-routed gates.
Mirrors the reference's statistical-test style (tlwe.rs:281-304,
10,000-trial) at 1000x the trial count.

Chained layers keep the test honest: each layer consumes the previous
layer's bootstrapped outputs, so accumulated phase noise — not fresh
encryption noise — is what each bootstrap must absorb.

    python scripts/soak.py
    RS_TFHE_SOAK_GATES=2e4 RS_TFHE_SOAK_ADDS=64 python scripts/soak.py

Writes chiprun_out/soak.json after each phase.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu as tfhe  # noqa: E402
from rs_tfhe_tpu import gates, models, tlwe  # noqa: E402
from rs_tfhe_tpu.utils.cache import enable_compile_cache  # noqa: E402

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "chiprun_out", "soak.json",
)

#: gates per jitted dispatch layer pair (see _layers): one NAND + one XOR
BATCH = 4096
LAYERS = 8  # gate layers fused per dispatch (keeps dispatch overhead <1%)


def _layers(a, b, ck):
    """LAYERS alternating bootstrapped layers; every output feeds the next:
    (a, b) -> (nand(a, b), xor(a, b)) -> ... Returns final (a, b)."""
    for _ in range(LAYERS // 2):
        a, b = gates.nand(a, b, ck), gates.xor(a, b, ck)
    return a, b


def soak_gates(pname: str, target_gates: int, key0: int = 100,
               batch: int = BATCH, multibit: bool = False) -> dict:
    p = tfhe.ALL_SECURITY_SETS[pname]
    sk = tfhe.SecretKey.generate(jax.random.key(key0), p)
    ck = tfhe.CloudKey.generate(jax.random.key(key0 + 1), sk,
                                multibit=multibit)
    rng = np.random.default_rng(1)
    a_bits = rng.integers(0, 2, batch).astype(bool)
    b_bits = rng.integers(0, 2, batch).astype(bool)
    a = tlwe.lwe_encrypt_bool(jax.random.key(key0 + 2), sk.lv0,
                              jnp.asarray(a_bits), p.tlwe_lv0.alpha)
    b = tlwe.lwe_encrypt_bool(jax.random.key(key0 + 3), sk.lv0,
                              jnp.asarray(b_bits), p.tlwe_lv0.alpha)

    # ck/sk are jit ARGUMENTS, not closures — closed-over keys would embed
    # into the program as constants
    run = jax.jit(_layers)
    dec = jax.jit(
        lambda x, y, s: (tlwe.lwe_decrypt_bool(x, s),
                         tlwe.lwe_decrypt_bool(y, s))
    )

    gates_done = 0
    errors = 0
    # warm compile outside the timed region
    a_w, b_w = jax.block_until_ready(run(a, b, ck))
    t0 = time.perf_counter()
    a, b = a_w, b_w
    for _ in range(LAYERS // 2):
        a_bits, b_bits = (~(a_bits & b_bits), a_bits ^ b_bits)
    gates_done += LAYERS * batch
    while gates_done < target_gates:
        a, b = run(a, b, ck)
        for _ in range(LAYERS // 2):
            a_bits, b_bits = (~(a_bits & b_bits), a_bits ^ b_bits)
        da, db = dec(a, b, sk.lv0)
        da = np.asarray(jax.device_get(da))
        db = np.asarray(jax.device_get(db))
        errors += int((da != a_bits).sum()) + int((db != b_bits).sum())
        gates_done += LAYERS * batch
        if errors:
            break
    dt = time.perf_counter() - t0
    return {
        "params": pname,
        "multibit": multibit,
        "batch": batch,
        "gates": gates_done,
        "errors": errors,
        "seconds": round(dt, 1),
        "gates_per_s": round(gates_done / dt, 1),
        "p_fail_upper_95": round(3.0 / gates_done, 12) if errors == 0
        else round(errors / gates_done, 12),
    }


def soak_nibble(target_adds: int) -> dict:
    p = tfhe.SECURITY_128_BIT_NIBBLE
    sk = tfhe.SecretKey.generate(jax.random.key(110), p)
    ck = tfhe.CloudKey.generate(jax.random.key(111), sk)
    rng = np.random.default_rng(2)
    batch = 256
    adds = 0
    errors = 0
    t0 = time.perf_counter()
    i = 0
    while adds < target_adds:
        xs = rng.integers(0, 256, batch)
        ys = rng.integers(0, 256, batch)
        na = models.encrypt_radix(jax.random.key(112 + 2 * i), sk.lv0, xs, 2,
                                  p, base_bits=4)
        nb = models.encrypt_radix(jax.random.key(113 + 2 * i), sk.lv0, ys, 2,
                                  p, base_bits=4)
        nsum = models.add_radix(na, nb, ck, base_bits=4)  # 3 PBS per add
        dec = np.asarray(models.decrypt_radix(nsum, sk.lv0, base_bits=4))
        errors += int((dec != (xs + ys) % 256).sum())
        adds += batch
        i += 1
        if errors:
            break
    dt = time.perf_counter() - t0
    return {
        "params": "SECURITY_128_BIT_NIBBLE",
        "adds": adds,
        "pbs": 3 * adds,
        "errors": errors,
        "seconds": round(dt, 1),
        "p_fail_per_pbs_upper_95": round(3.0 / (3 * adds), 12) if errors == 0
        else round(errors / (3 * adds), 12),
    }


def main() -> None:
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("the soak runs on a GPU")
    enable_compile_cache()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    target_gates = int(float(os.environ.get("RS_TFHE_SOAK_GATES", "1e7")))
    target_adds = int(float(os.environ.get("RS_TFHE_SOAK_ADDS", "1e4")))
    print(f"device: {jax.devices()[0]}")
    # write after each phase so a timeout kill keeps the finished phase
    target_strict = int(float(os.environ.get("RS_TFHE_SOAK_STRICT_GATES",
                                              "1e7")))
    artifact: dict = {"ts": time.time()}
    print(f"soaking {target_gates:.0e} FAST gates ...", flush=True)
    fast = soak_gates("SECURITY_128_BIT_FAST", target_gates)
    print(json.dumps(fast))
    artifact["fast"] = fast
    with open(OUT, "w") as f:
        json.dump(artifact, f, indent=1)
    # the literal reference set, same chained-layer harness (bench.py's
    # strict_* rows get the matching reliability evidence)
    print(f"soaking {target_strict:.0e} STRICT gates ...", flush=True)
    strict = soak_gates("SECURITY_128_BIT", target_strict, key0=120)
    print(json.dumps(strict))
    artifact["strict"] = strict
    with open(OUT, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"soaking {target_adds} NIBBLE adds ...", flush=True)
    nib = soak_nibble(target_adds)
    print(json.dumps(nib))
    artifact["nibble"] = nib
    with open(OUT, "w") as f:
        json.dump(artifact, f, indent=1)
    # multi-bit latency path (CloudKey(multibit=True), B=2 chained layers):
    # hardware evidence behind the mb margin model (FAST mb: 7.4 sigma,
    # p ~ 2e-13/gate) — the path bench.py's latency_ms_b1_mb row measures
    target_mb = int(float(os.environ.get("RS_TFHE_SOAK_MB_GATES", "1e6")))
    print(f"soaking {target_mb:.0e} FAST mb gates (B=2) ...", flush=True)
    mb = soak_gates("SECURITY_128_BIT_FAST", target_mb, key0=140,
                    batch=2, multibit=True)
    print(json.dumps(mb))
    artifact["fast_mb"] = mb
    with open(OUT, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {OUT}")
    ok = all(r["errors"] == 0 for r in (fast, strict, nib, mb))
    print("SOAK", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
