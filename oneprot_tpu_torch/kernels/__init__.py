"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor, or raises: there is no fallback. Each launcher
counts its launches in a plain integer attribute, `<launcher>.launches`.
The kernels are built with nvcc on first use (see `_build`).
"""
