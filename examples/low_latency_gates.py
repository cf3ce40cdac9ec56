"""Single-gate latency with a multi-bit (pair-grouped) bootstrapping key.

No reference analog — rs-tfhe rotates bit-serially (trgsw.rs:209-223) and
its single gate costs ~15 ms. A `CloudKey.generate(..., multibit=True)` key
additionally stores TRGSW encryptions of the four pair-indicator products
per PAIR of lv0 secret bits, so one external product advances the blind
rotation by TWO mask elements; gates auto-route batches <= 2 through the
half-length chain. Noise (utils.noise.estimate(params, mb_group=2)): 12.7
sigma vs 13.1 standard at SECURITY_128_BIT; FAST mb runs 7.4 sigma,
p ~ 2e-13/gate. Its latency on the GPU has not been measured yet.

    python examples/low_latency_gates.py --cpu                # TEST_TINY
    python examples/low_latency_gates.py --params SECURITY_128_BIT
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
from _common import parse_args

from rs_tfhe_tpu import gates
from rs_tfhe_tpu.key import CloudKey, SecretKey
from rs_tfhe_tpu.tlwe import lwe_decrypt_bool, lwe_encrypt_bool
from rs_tfhe_tpu.utils.noise import estimate


def chain(n, key):
    @jax.jit
    def run(x, y, ck):
        for _ in range(n):
            x = gates.nand(x, y, ck)
        return x

    return run


def measure(a, b, ck, label, n_long=25, reps=3):
    """Chain-length slope: (t_long - t5) / (n_long - 5), min over repeats —
    cancels the per-dispatch overhead a pipelined workload would not pay."""
    short, long_ = chain(5, ck), chain(n_long, ck)
    ts = []
    for fn in (short, long_):
        jax.block_until_ready(fn(a, b, ck))  # compile
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(a, b, ck)
            np.asarray(jax.device_get(out[0, -1]))
            best = min(best, time.perf_counter() - t0)
        ts.append(best)
    ms = (ts[1] - ts[0]) / (n_long - 5) * 1e3
    print(f"[{label}] single-gate latency: {ms:.2f} ms")
    return ms


def main():
    # --long/--reps: slope chain length and repeats (the CI smoke run
    # shrinks them; compile time of the unrolled long chain dominates on
    # a single CPU core)
    args = parse_args(__doc__, long=25, reps=3)
    p = args.param_set
    sk = SecretKey.generate(jax.random.key(0), p)
    t0 = time.perf_counter()
    ck = CloudKey.generate(jax.random.key(1), sk)
    jax.block_until_ready(ck.bsk)
    print(f"[keygen standard] {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    ck_mb = CloudKey.generate(jax.random.key(1), sk, multibit=True)
    jax.block_until_ready(ck_mb.bsk_mb)
    print(f"[keygen multibit] {time.perf_counter() - t0:.2f}s "
          f"(~2x BSK material)")

    e = estimate(p, mb_group=2)
    print(f"[noise] mb bootstrap-out sigma: {e.bootstrap_out_std:.3e} "
          f"(gate p_fail ~ {e.gate_fail_prob:.1e})")

    bits = np.array([True])
    a = lwe_encrypt_bool(jax.random.key(2), sk.lv0, jnp.asarray(bits),
                         p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(jax.random.key(3), sk.lv0, jnp.asarray(~bits),
                         p.tlwe_lv0.alpha)

    out = gates.nand(a, b, ck_mb)  # B=1 -> auto-routes the mb chain
    dec = np.asarray(lwe_decrypt_bool(out, sk.lv0))
    assert dec.tolist() == [True], dec  # NAND(1, 0) = 1
    print("[mb gate] correct")

    ms_std = measure(a, b, ck, "standard key", args.long, args.reps)
    ms_mb = measure(a, b, ck_mb, "multibit key", args.long, args.reps)
    print(f"[speedup] {ms_std / ms_mb:.2f}x  (reference: ~15 ms/gate)")


if __name__ == "__main__":
    main()
