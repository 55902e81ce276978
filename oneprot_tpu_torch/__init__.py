"""PyTorch / CUDA port of oneprot_tpu for NVIDIA Hopper (H100).

The package mirrors oneprot_tpu's layout (`cli/`, `core/`, `data/`,
`kernels/`, `models/`, `train/`, `serving.py`) and imports torch, numpy and
the standard library only (`configs/` is read by `core/yaml_io.py`).
Entry points and modules are built on the card in bf16 (`device="cuda"`,
the hub's dtype) unless the caller passes `device="cpu"` (and, to compare
with f32 references, `dtype=torch.float32`); on the CPU every kernel runs
its plain PyTorch version.
"""
