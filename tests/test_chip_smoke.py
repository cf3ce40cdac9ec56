"""chip_smoke.py off the card: it refuses to run without a GPU, and its HLO
reader tells a GEMM from a contraction XLA would emit as a loop."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu():
    res = _run(ROOT, ROOT / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no GPU" in res.stderr


def test_fails_alone_in_empty_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


_FUSED = """\
%fused_dot (p0: s8[64,4096], p1: s8[8192,4096]) -> s32[64,8192] {
  %p0 = s8[64,4096]{1,0} parameter(0)
  %p1 = s8[8192,4096]{1,0} parameter(1)
  ROOT %d = s32[64,8192]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={1}
}

"""
_ENTRY = """\
ENTRY %main (a: s8[64,4096], b: s8[8192,4096]) -> s32[64,8192] {
  %a = s8[64,4096]{1,0} parameter(0)
  %b = s8[8192,4096]{1,0} parameter(1)
  ROOT %out = s32[64,8192]{1,0} LINE
}
"""

#: case -> (root instruction, expected label, is a loop, needs %fused_dot)
_CASES = {
    "cublas": ('custom-call(%a, %b), custom_call_target="__cublas$lt$matmul"',
               "custom-call __cublas$lt$matmul", False, False),
    "triton": ('fusion(%a, %b), kind=kCustom, calls=%fused_dot, '
               'backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}',
               "fusion __triton_gemm", False, True),
    "loop": ("fusion(%a, %b), kind=kLoop, calls=%fused_dot",
             "fusion kLoop", True, True),
    "unfused": ("dot(%a, %b), lhs_contracting_dims={1}, "
                "rhs_contracting_dims={1}", "unfused dot", True, False),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_contraction_lowerings(case):
    line, label, is_loop, fused = _CASES[case]
    hlo = (_FUSED if fused else "") + _ENTRY.replace("LINE", line)
    got = cs.contraction_lowerings(hlo)
    assert got == [(label, "s8[64,4096]", "s8[8192,4096]")]
    assert cs.is_loop_lowering(label) is is_loop


def test_golden_stage_table_matches_capture():
    from rs_tfhe_tpu.utils import golden

    stored = np.load(golden.GOLDEN_PATH)
    assert sorted(stored.files) == sorted(
        [*golden.STAGES, *map(golden.digest_key, golden.GROUPS)])
    assert set(golden.STAGES.values()) == set(golden.GROUPS)
    for group in golden.GROUPS:
        digest = stored[golden.digest_key(group)]
        assert digest.dtype == np.uint8 and digest.shape == (32,)


def test_golden_inputs_follow_capture_draw_order():
    from rs_tfhe_tpu.utils import golden

    a = golden.stage_inputs()
    b = golden.stage_inputs()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(a.a_bits, rng.integers(0, 2, 64) == 1)
    assert a.nib_x.shape == (256,) and a.mul_x.shape == (32,)
    assert a.nib_x.max() < 256 and a.mul_y.max() < 256
