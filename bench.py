"""Headline benchmark: bootstrapped-gate throughput at 128-bit security.

Default parameter set SECURITY_128_BIT_FAST: identical LWE hardness to the
reference's SECURITY_128_BIT (same n and alpha on both levels) with a leaner
gadget (L=2, Bg=2^8) enabled by our centered decomposition — see params.py.

Measures batched NAND gates/sec (each gate = one full TFHE gate bootstrap:
blind rotate + sample extract + key switch) on the default JAX device and
prints ONE JSON line. Baseline: the reference's ~15 ms/gate single-core claim
(rs-tfhe README.md:217, BASELINE.md) = 66.7 gates/sec.

The line's headline fields are the FAST-set throughput; it ALSO carries the
apples-to-apples numbers at the literal SECURITY_128_BIT set the baseline
names (L=3, Bg=2^6 — reference params.rs:379-404) under "strict_*" keys,
plus single-gate (batch 1) latency for both sets, so the FAST hardness
argument stands BESIDE a strict-set measurement rather than instead of it.

Env overrides: RS_TFHE_BENCH_BATCH (default 4096), RS_TFHE_BENCH_ITERS
(default 5), RS_TFHE_BENCH_PARAMS (default SECURITY_128_BIT_FAST; setting
it skips the extra strict-set pass), RS_TFHE_BENCH_STRICT=0 to skip the
strict pass explicitly.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rs_tfhe_tpu import ALL_SECURITY_SETS
from rs_tfhe_tpu.gates import batch_gate
from rs_tfhe_tpu.key import CloudKey, SecretKey
from rs_tfhe_tpu.tlwe import lwe_decrypt_bool, lwe_encrypt_bool
from rs_tfhe_tpu.utils.cache import enable_compile_cache

BASELINE_GATES_PER_SEC = 1000.0 / 15.0  # reference: ~15 ms/gate


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _make_chain(n: int):
    """n gates chained inside one jit (each consumes the previous output)."""

    @jax.jit
    def chained_gates(x, y, key):
        # key passed as an ARGUMENT: a closure-captured CloudKey would
        # be inlined into the program as constants
        for _ in range(n):
            x = batch_gate("nand", x, y, key)
        return x

    return chained_gates


def _mb_enabled(params) -> bool:
    """Multi-bit latency pass: needs an even n0; RS_TFHE_BENCH_MB=0 skips
    it."""
    return os.environ.get("RS_TFHE_BENCH_MB", "1") == "1" and params.n0 % 2 == 0


def measure(pname: str, batch: int, iters: int) -> dict:
    """Keygen + batched NAND throughput + single-gate latency at one set."""
    params = ALL_SECURITY_SETS[pname]
    log(f"--- params={pname} batch={batch} iters={iters}")

    t0 = time.perf_counter()
    sk = SecretKey.generate(jax.random.key(42), params)
    ck = jax.block_until_ready(CloudKey.generate(jax.random.key(7), sk))
    log(f"keygen (incl. compile): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    ck = jax.block_until_ready(CloudKey.generate(jax.random.key(8), sk))
    keygen_warm = time.perf_counter() - t0
    log(f"keygen warm: {keygen_warm * 1e3:.0f} ms")

    rng = np.random.default_rng(0)
    bits_a = rng.integers(0, 2, batch).astype(bool)
    bits_b = rng.integers(0, 2, batch).astype(bool)
    ka, kb = jax.random.split(jax.random.key(3))
    a = lwe_encrypt_bool(ka, sk.lv0, jnp.asarray(bits_a), params.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(kb, sk.lv0, jnp.asarray(bits_b), params.tlwe_lv0.alpha)

    t0 = time.perf_counter()
    out = jax.block_until_ready(batch_gate("nand", a, b, ck))
    log(f"first call (compile + run): {time.perf_counter() - t0:.2f}s")

    dec = np.asarray(jax.device_get(lwe_decrypt_bool(out, sk.lv0)))
    correct = (dec == ~(bits_a & bits_b)).mean()
    log(f"correctness: {correct:.4f}")

    # Chain iterations (each gate consumes the previous output).
    t0 = time.perf_counter()
    cur = a
    for _ in range(iters):
        cur = batch_gate("nand", cur, b, ck)
    jax.block_until_ready(cur)
    elapsed = time.perf_counter() - t0
    per_iter = elapsed / iters
    log(f"{iters} chained iters: {per_iter * 1e3:.1f} ms each")
    gates_per_sec = batch / per_iter

    # single-gate (batch 1) latency: gates chained INSIDE one jit (each
    # consumes the previous output) so the measurement is the gate's
    # steady-state device latency. Two chain lengths, slope = (t_long -
    # t_short) / (n_long - n_short): cancels the per-dispatch overhead. Min
    # over repeats.
    a1, b1 = a[:1], b[:1]
    n_short, n_long = 5, 25

    def min_time(fn, key, repeats=4):
        _ = jax.block_until_ready(fn(a1, b1, key))  # compile + warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(a1, b1, key))
            best = min(best, time.perf_counter() - t0)
        return best

    def chain_slope(key):
        t_short = min_time(_make_chain(n_short), key)
        t_long = min_time(_make_chain(n_long), key)
        ms = (t_long - t_short) / (n_long - n_short) * 1e3
        log(
            f"single-gate latency: {ms:.1f} ms (chains {n_short}/{n_long}: "
            f"{t_short * 1e3:.1f}/{t_long * 1e3:.1f} ms)"
        )
        return ms

    latency_ms = chain_slope(ck)

    res = {
        "gates_per_sec": round(gates_per_sec, 2),
        "latency_ms_b1": round(latency_ms, 2),
        "keygen_warm_ms": round(keygen_warm * 1e3, 1),
        "correctness": float(correct),
    }

    if _mb_enabled(params):
        # multi-bit (pair-grouped) latency: gates auto-route batches <= 2
        # through the half-length chain when the key carries mb material
        ck_mb = jax.block_until_ready(
            CloudKey.generate(jax.random.key(7), sk, multibit=True))
        out_mb = jax.block_until_ready(batch_gate("nand", a1, b1, ck_mb))
        ok = bool(
            np.asarray(jax.device_get(lwe_decrypt_bool(out_mb, sk.lv0)))[0]
            == ~(bits_a[0] & bits_b[0])
        )
        log(f"mb gate correct: {ok}")
        res["latency_ms_b1_mb"] = round(chain_slope(ck_mb), 2)
        if not ok:
            res["mb_correct"] = False
    return res


def main() -> None:
    batch = int(os.environ.get("RS_TFHE_BENCH_BATCH", "4096"))
    iters = int(os.environ.get("RS_TFHE_BENCH_ITERS", "5"))
    pname = os.environ.get("RS_TFHE_BENCH_PARAMS")
    run_strict = (
        pname is None and os.environ.get("RS_TFHE_BENCH_STRICT", "1") == "1"
    )
    pname = pname or "SECURITY_128_BIT_FAST"

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX's device is "
                         f"{dev.platform!r}")
    enable_compile_cache()
    log(f"device={dev} kind={dev.device_kind} count={len(jax.devices())}")

    main_res = measure(pname, batch, iters)

    result = {
        "metric": "gate_bootstraps_per_sec",
        "value": main_res["gates_per_sec"],
        "unit": "gates/s",
        "vs_baseline": round(main_res["gates_per_sec"] / BASELINE_GATES_PER_SEC, 2),
        "params": pname,
        "latency_ms_b1": main_res["latency_ms_b1"],
        "keygen_warm_ms": main_res["keygen_warm_ms"],
    }
    if "latency_ms_b1_mb" in main_res:
        result["latency_ms_b1_mb"] = main_res["latency_ms_b1_mb"]
    if main_res["correctness"] < 1.0:
        result["correctness"] = main_res["correctness"]

    if run_strict:
        # apples-to-apples at the literal reference set BASELINE.json names
        strict = measure("SECURITY_128_BIT", batch, iters)
        result["strict_params"] = "SECURITY_128_BIT"
        result["strict_gates_per_sec"] = strict["gates_per_sec"]
        result["strict_latency_ms_b1"] = strict["latency_ms_b1"]
        if "latency_ms_b1_mb" in strict:
            result["strict_latency_ms_b1_mb"] = strict["latency_ms_b1_mb"]
        result["strict_vs_baseline"] = round(
            strict["gates_per_sec"] / BASELINE_GATES_PER_SEC, 2
        )
        if strict["correctness"] < 1.0:
            result["strict_correctness"] = strict["correctness"]

    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
