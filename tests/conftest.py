"""Test configuration: force CPU with a virtual 8-device mesh.

Must run before jax initializes, so this sits at the top of conftest.
"""

import os

# Unit tests validate math and sharding on a virtual 8-device CPU mesh; the
# GPU path at production sizes is covered by chip_smoke.py. Tests marked
# `gpu` take the `gpu_device` fixture, which skips them without a GPU; run
# them on the card with RS_TFHE_TEST_GPU=1 python -m pytest tests/ -m gpu.
ON_CPU = os.environ.get("RS_TFHE_TEST_GPU") != "1"
if ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# Cap XLA:CPU codegen at AVX2. This (virtualized) Xeon advertises
# AVX-512/AMX feature bits, and XLA:CPU's host detection also emits
# "+prefer-no-gather" (the slow-gather/Downfall hint) which the loader then
# reports as unsupported; in-suite we have observed both SIGILL warnings
# and hard SEGFAULTs inside backend_compile_and_load / deserialize_executable
# (see note below). Restricting to AVX2 keeps codegen off the AVX-512
# gather paths entirely. Tests are TEST_TINY-sized; the throughput loss is
# irrelevant.
if "xla_cpu_max_isa" not in flags:
    flags = (flags + " --xla_cpu_max_isa=AVX2").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")

# NO persistent compilation cache on CPU: this jaxlib's XLA:CPU AOT cache
# loader is unsafe on this host — it logs "Target machine feature
# +prefer-no-gather is not supported on the host machine ... could lead to
# execution errors such as SIGILL" (cpu_aot_loader.cc:210) on every load,
# and one specific executable reproducibly SEGFAULTS the suite inside
# backend.deserialize_executable (jax compilation_cache.py:238, observed
# 3x at tests/test_radix_compare.py in-suite, 2026-08-17/18 — even with a
# freshly written cache, so this is a load-path bug, not corruption).
# GPU runs keep the cache (rs_tfhe_tpu/utils/cache.py).
jax.config.update("jax_compilation_cache_dir", None)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from rs_tfhe_tpu import params as P  # noqa: E402
from rs_tfhe_tpu.key import CloudKey, SecretKey  # noqa: E402

#: Canonical batch size used across tests to minimize recompilation.
BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    XLA:CPU on this host segfaults while LOADING a freshly compiled (or
    cache-loaded) executable once enough executables have accumulated in
    the process — reproducibly at tests/test_radix_compare.py when run
    after ~115 other tests, never in isolation, with or without the
    persistent cache, before and after capping codegen at AVX2. Dropping
    compiled programs at module boundaries keeps the loader below
    whatever placement limit it is tripping; the recompiles are
    TEST_TINY-sized (seconds)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, for tests marked `gpu`; skips where there is none.
    Decided here, at test time, never at import or collection."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run on the card: pytest -m gpu)")


@pytest.fixture(scope="session")
def tiny():
    return P.TEST_TINY


@pytest.fixture(scope="session")
def sk(tiny):
    return SecretKey.generate(jax.random.key(42), tiny)


@pytest.fixture(scope="session")
def sk_dirty(tiny):
    """Second, unrelated key ("key_dirty" in the reference tests)."""
    return SecretKey.generate(jax.random.key(1337), tiny)


@pytest.fixture(scope="session")
def ck(sk):
    return CloudKey.generate(jax.random.key(7), sk)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
