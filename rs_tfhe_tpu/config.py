"""Global backend configuration.

Environment overrides:
  RS_TFHE_DOT_IMPL  = int8 | bf16              (default int8)
  RS_TFHE_STEP_IMPL = auto | xla | nussbaumer  (default auto)

`dot_impl` selects how the exact limb contractions are issued:
  - "int8": s8 x s8 -> s32 `lax.dot_general` (int8 tensor cores run at twice
    the bf16 rate).
  - "bf16": bf16 x bf16 -> f32 with the contraction chunked to <= 1024 so every
    partial sum stays within float32's exact-integer range (see ops/poly.py).

`step_impl` selects the blind-rotation step (ops/blind_rotate.py):
  - "auto" / "xla": the exact int8 circulant contraction;
  - "nussbaumer": the Nussbaumer transform path (ops/nussbaumer.py).
Any other value raises ValueError at the first blind rotation. All paths
are bit-exact.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    dot_impl: str = os.environ.get("RS_TFHE_DOT_IMPL", "int8")
    step_impl: str = os.environ.get("RS_TFHE_STEP_IMPL", "auto")


config = Config()
