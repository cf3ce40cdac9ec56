"""EVERY example runs end-to-end at TEST_TINY on CPU (the reference runs
its examples in CI, .github/workflows/ci.yml:74-81). Parametrized over the
directory listing, so a new example is covered the day it lands and a
rotted one fails loudly (review round 1 weak item 1)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

#: per-example extra CLI flags to keep CPU runtime in budget (the flags
#: shrink SIZES only — every code path still runs; full-size coverage of
#: the same paths lives in the unit tests and chip_smoke.py)
EXTRA_FLAGS = {
    "multi_chip_scaling.py": ["--batch", "64"],
    "encrypted_sort.py": ["--n", "2", "--width", "4"],
    "radix_integers.py": ["--digits", "2"],
    "low_latency_gates.py": ["--long", "9", "--reps", "1"],
    "ciphertext_multiply.py": ["--bits", "2", "--x", "3", "--y", "2"],
    "batch_gates.py": ["--max_batch", "64"],
}

ALL_EXAMPLES = sorted(
    p.name for p in EXAMPLES.glob("*.py") if not p.name.startswith("_")
)


def _run(name, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # the multi-chip demo needs a virtual device mesh
    if "multi_chip" in name:
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        )
    return subprocess.run(
        [sys.executable, str(EXAMPLES / name), "--cpu", *EXTRA_FLAGS.get(name, [])],
        capture_output=True, text=True, timeout=timeout, env=env,
    )


def test_every_example_is_listed():
    assert len(ALL_EXAMPLES) >= 13, ALL_EXAMPLES


@pytest.mark.parametrize("name", ALL_EXAMPLES)
def test_example_runs(name):
    res = _run(name)
    assert res.returncode == 0, (res.stdout[-1000:], res.stderr[-2000:])
