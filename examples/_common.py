"""Shared example scaffolding: parameter selection, keygen, timing."""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import rs_tfhe_tpu as tfhe  # noqa: E402
from rs_tfhe_tpu.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu.utils.cache import enable_compile_cache  # noqa: E402


def parse_args(description: str, **extra_flags) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument(
        "--params",
        default="TEST_TINY",
        choices=["TEST_TINY", *tfhe.ALL_SECURITY_SETS],
        help="parameter set (TEST_TINY runs in seconds on CPU; "
        "SECURITY_128_BIT is the production set)",
    )
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    for name, default in extra_flags.items():
        ap.add_argument(f"--{name}", type=type(default), default=default)
    args = ap.parse_args()
    if args.cpu:
        # no persistent cache on the CPU: XLA:CPU's AOT cache loader can
        # SIGILL/segfault loading a cached executable (tests/conftest.py)
        jax.config.update("jax_platforms", "cpu")
    else:
        enable_compile_cache()
    args.param_set = (
        tfhe.TEST_TINY if args.params == "TEST_TINY" else tfhe.ALL_SECURITY_SETS[args.params]
    )
    return args


def make_keys(params, seed: int = 0):
    t0 = time.perf_counter()
    sk = SecretKey.generate(jax.random.key(seed), params)
    ck = CloudKey.generate(jax.random.key(seed + 1), sk)
    jax.block_until_ready(ck.bsk)
    print(f"[keygen] {params.description}: {time.perf_counter() - t0:.2f}s")
    return sk, ck


def timed(label: str, fn, *args):
    """Run fn, wait for the result, report wall time."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    print(f"[{label}] {time.perf_counter() - t0:.3f}s")
    return out
