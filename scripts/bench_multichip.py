"""Multi-chip scaling harness — parity with the reference's
examples/batch_gates_scaling.rs (cores -> speedup table), ready to fire the
day a real multi-chip slice is attached.

Measures, on a (batch[, model]) mesh over 1..N devices:
  - DP gate throughput (data_parallel_gate, zero collectives): strong
    scaling (fixed total batch) and weak scaling (fixed per-device batch);
  - TP-vs-DP single-dispatch latency at B in {1, 8, 64}
    (tensor_parallel_gate shards the BSK/KSK contractions with one psum per
    CMUX step — the latency play for batches too small to fill the mesh).

Every measured point is decrypt-verified. Writes one JSON record.

On a single-chip/virtual run this validates plumbing + correctness; the
wall-clock "speedups" of virtual CPU devices share one host and are marked
`"virtual": true` in the artifact — they answer "does it scale mechanically",
not "how fast". Run on real hardware: `python scripts/bench_multichip.py`
picks up every attached device automatically.

Env: RS_TFHE_SCALING_PARAMS (default TEST_TINY on cpu, SECURITY_128_BIT_FAST
on a GPU), RS_TFHE_SCALING_OUT (default chiprun_out/scaling.json),
RS_TFHE_SCALING_DEVICES (cap the device count).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Virtual 8-device CPU mesh when no multi-chip hardware is attached: must be
# set before importing jax.
if "--virtual" in sys.argv or os.environ.get("JAX_PLATFORMS", "") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        )

import jax  # noqa: E402

from rs_tfhe_tpu.utils.cache import enable_compile_cache  # noqa: E402

if os.environ.get("JAX_PLATFORMS") != "cpu":
    enable_compile_cache()  # off on the CPU, as in the tests

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import ALL_SECURITY_SETS  # noqa: E402
from rs_tfhe_tpu.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu.parallel.mesh import make_mesh  # noqa: E402
from rs_tfhe_tpu.parallel.sharded import (  # noqa: E402
    data_parallel_gate,
    tensor_parallel_gate,
)
from rs_tfhe_tpu.tlwe import lwe_decrypt_bool, lwe_encrypt_bool  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(x) -> None:
    jax.block_until_ready(x)


def _time(fn, *args, iters: int = 3) -> float:
    out = fn(*args)
    _sync(out)  # compile + warm
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def main() -> None:
    platform = jax.devices()[0].platform
    n_avail = len(jax.devices())
    n_max = int(os.environ.get("RS_TFHE_SCALING_DEVICES", str(n_avail)))
    n_max = min(n_max, n_avail)
    pname = os.environ.get(
        "RS_TFHE_SCALING_PARAMS",
        "TEST_TINY" if platform == "cpu" else "SECURITY_128_BIT_FAST",
    )
    if pname == "TEST_TINY":
        from rs_tfhe_tpu.params import TEST_TINY

        params = TEST_TINY
    else:
        params = ALL_SECURITY_SETS[pname]
    virtual = platform == "cpu"
    log(f"platform={platform} devices={n_max} params={pname} virtual={virtual}")

    sk = SecretKey.generate(jax.random.key(42), params)
    ck = CloudKey.generate(jax.random.key(7), sk)

    rng = np.random.default_rng(0)

    def enc_pair(batch: int):
        bits_a = rng.integers(0, 2, batch).astype(bool)
        bits_b = rng.integers(0, 2, batch).astype(bool)
        a = lwe_encrypt_bool(jax.random.key(1), sk.lv0, jnp.asarray(bits_a),
                             params.tlwe_lv0.alpha)
        b = lwe_encrypt_bool(jax.random.key(2), sk.lv0, jnp.asarray(bits_b),
                             params.tlwe_lv0.alpha)
        return a, b, bits_a, bits_b

    def check(out, bits_a, bits_b) -> float:
        dec = np.asarray(jax.device_get(lwe_decrypt_bool(out, sk.lv0)))
        return float((dec == ~(bits_a & bits_b)).mean())

    device_counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= n_max]

    # --- DP strong scaling: fixed total batch over 1..N devices ---
    total_b = 512 if virtual else 4096
    a, b, bits_a, bits_b = enc_pair(total_b)
    strong = []
    for nd in device_counts:
        mesh = make_mesh(nd)
        dt = _time(lambda x, y: data_parallel_gate("nand", x, y, ck, mesh), a, b)
        corr = check(data_parallel_gate("nand", a, b, ck, mesh), bits_a, bits_b)
        rate = total_b / dt
        strong.append({"devices": nd, "gates_per_sec": round(rate, 1),
                       "correctness": corr})
        log(f"  DP strong n={nd}: {rate:,.0f} gates/s corr={corr}")

    # --- DP weak scaling: fixed per-device batch ---
    per_dev = 128 if virtual else 2048
    weak = []
    for nd in device_counts:
        aw, bw, wa, wb = enc_pair(per_dev * nd)
        mesh = make_mesh(nd)
        dt = _time(lambda x, y: data_parallel_gate("nand", x, y, ck, mesh), aw, bw)
        corr = check(data_parallel_gate("nand", aw, bw, ck, mesh), wa, wb)
        rate = per_dev * nd / dt
        weak.append({"devices": nd, "batch": per_dev * nd,
                     "gates_per_sec": round(rate, 1), "correctness": corr})
        log(f"  DP weak n={nd} (B={per_dev * nd}): {rate:,.0f} gates/s corr={corr}")

    # --- TP vs DP latency at small batches (full mesh) ---
    tp_rows = []
    g = params.trgsw_lv1
    tp_size = n_max
    # TP needs model-axis | 2L and | N
    while tp_size > 1 and ((2 * g.l) % tp_size or params.n1 % tp_size):
        tp_size //= 2
    for batch in (1, 8, 64):
        at, bt, ta, tb = enc_pair(batch)
        mesh_dp = make_mesh(n_max)
        dt_dp = _time(lambda x, y: data_parallel_gate("nand", x, y, ck, mesh_dp),
                      at, bt, iters=2)
        row = {"batch": batch, "dp_latency_ms": round(dt_dp * 1e3, 2)}
        if tp_size > 1:
            mesh_tp = make_mesh(n_max, tp=tp_size)
            pad = (-batch) % (n_max // tp_size)
            atp = jnp.pad(at, ((0, pad), (0, 0)))
            btp = jnp.pad(bt, ((0, pad), (0, 0)))
            dt_tp = _time(
                lambda x, y: tensor_parallel_gate("nand", x, y, ck, mesh_tp),
                atp, btp, iters=2)
            out_tp = tensor_parallel_gate("nand", atp, btp, ck, mesh_tp)[:batch]
            row["tp_latency_ms"] = round(dt_tp * 1e3, 2)
            row["tp_model_axis"] = tp_size
            row["tp_correctness"] = check(out_tp, ta, tb)
            row["tp_wins"] = bool(dt_tp < dt_dp)
        tp_rows.append(row)
        log(f"  latency B={batch}: {row}")

    out = {
        "platform": platform,
        "virtual": virtual,
        "params": pname,
        "devices_available": n_avail,
        "dp_strong_scaling": strong,
        "dp_weak_scaling": weak,
        "tp_vs_dp_latency": tp_rows,
        "note": (
            "virtual CPU devices share one host: correctness/plumbing "
            "validation only, not hardware scaling numbers"
            if virtual else "real hardware"
        ),
    }
    path = os.environ.get(
        "RS_TFHE_SCALING_OUT",
        os.path.join(os.path.dirname(__file__), "..", "chiprun_out",
                     "scaling.json"),
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
