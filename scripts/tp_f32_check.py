#!/usr/bin/env python3
"""Tensor-parallel training in float32 on one card: `chip_smoke.py`'s
phase 27 (`experiment=train_packed data=struct_token_only
trainer.mesh.model=2`, two gloo ranks, the ESM2-650M hub and the
trainable 35M tower split over the model axis) with both towers in f32,
through the f32 instances of #1-#3.

    python3 scripts/tp_f32_check.py

In bf16 the model axis rounds the hub's and the tower's sums at other
places than one process does, and Adam's near-sign first updates turn
that into sign flips of small elements: the change cosine against one
process reads ~0.995 there. In f32 the same steps must agree to the
change cosine's 0.999 and the losses to 1e-2, the control (the gradient
sum of `copy_to_model_group` dropped) must fall below it, and the
model-2 checkpoint must restore at model 1 exactly. Needs one CUDA card;
prints the phase's line and exits non-zero on a failed gate.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from oneprot_tpu_torch.kernels import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_f32_check: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.exact_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    chip_smoke.count_plain_calls()
    chip_smoke.tensor_parallel_phase("B32", smi, {}, min_cos=0.999)
    return 0


if __name__ == "__main__":
    sys.exit(main())
