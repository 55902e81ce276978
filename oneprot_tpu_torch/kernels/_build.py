"""Build the CUDA kernels of `kernels/csrc/` and load them with ctypes.

Each `csrc/<name>.cu` is compiled by one `nvcc` call into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). All sources are compiled in parallel on first use, into
`build/oneprot_tpu_torch/` at the root of the checkout, under a name that
carries the hash of the sources and flags: a changed source rebuilds, an
unchanged one is loaded as it is. There is no fallback: without `nvcc` or
a card, `library()` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "oneprot_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
# C signature of each library's entry point: (symbol, argtypes)
SIGNATURES = {
    "flash_mha_fwd": ("oneprot_flash_mha_fwd",
                      [_VOID_P] * 10 + [_INT] * 4 + [ctypes.c_float, _INT,
                                                     _VOID_P]),
    "flash_mha_bwd_dq": ("oneprot_flash_mha_bwd_dq",
                         [_VOID_P] * 13 + [_INT] * 4 + [ctypes.c_float] * 2
                         + [_INT, _VOID_P]),
    "flash_mha_bwd_dkv": ("oneprot_flash_mha_bwd_dkv",
                          [_VOID_P] * 12 + [_INT] * 4 + [ctypes.c_float, _INT,
                                                         _VOID_P]),
    "flash_mha_fwd_f32": ("oneprot_flash_mha_fwd_f32",
                          [_VOID_P] * 11 + [_INT] * 4 + [ctypes.c_float, _INT,
                                                         _VOID_P]),
    "flash_mha_bwd_dq_f32": ("oneprot_flash_mha_bwd_dq_f32",
                             [_VOID_P] * 14 + [_INT] * 4
                             + [ctypes.c_float] * 2 + [_INT, _VOID_P]),
    "flash_mha_bwd_dkv_f32": ("oneprot_flash_mha_bwd_dkv_f32",
                              [_VOID_P] * 12 + [_INT] * 4
                              + [ctypes.c_float, _INT, _VOID_P]),
    "flash_attention_fwd": ("oneprot_flash_attention_fwd",
                            [_VOID_P] * 7 + [_INT] * 5
                            + [ctypes.c_longlong] * 12
                            + [ctypes.c_float, _INT, _VOID_P]),
    "flash_attention_bwd_dq": ("oneprot_flash_attention_bwd_dq",
                               [_VOID_P] * 11 + [_INT] * 5
                               + [ctypes.c_longlong] * 21
                               + [ctypes.c_float] * 2 + [_INT, _VOID_P]),
    "flash_attention_bwd_dkv": ("oneprot_flash_attention_bwd_dkv",
                                [_VOID_P] * 10 + [_INT] * 5
                                + [ctypes.c_longlong] * 18 + [_INT, _VOID_P]),
    "gelu_quant": ("oneprot_gelu_quant",
                   [_VOID_P, _INT, _VOID_P, _VOID_P, ctypes.c_longlong, _INT,
                    _VOID_P]),
    "tied_row_attention": ("oneprot_tied_row_attention",
                           [_VOID_P] * 5 + [_INT] * 5 + [ctypes.c_float, _INT,
                                                         _VOID_P]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels "
                       "of oneprot_tpu_torch cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@functools.cache
def build_all() -> Dict[str, Path]:
    """Compile every missing library, all nvcc calls at once. Returns the
    library path of each source name. Raises on the first failed build."""
    targets = {name: _target(name) for name in SIGNATURES}
    missing = {n: p for n, p in targets.items() if not p.is_file()}
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, path in missing.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            log = open(path.with_suffix(".log"), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           log, tmp)
        failed = []
        for name, (proc, log, tmp) in procs.items():
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, missing[name])
            else:
                failed.append(name)
        if failed:
            logs = "\n".join(
                targets[n].with_suffix(".log").read_text() for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return targets


def build_log(name: str) -> str:
    """nvcc's output for the library's last build (register and spill
    counts come from -Xptxas=-v); empty when it was loaded as built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


@functools.cache
def library(name: str):
    """The bound C entry point of `csrc/<name>.cu`, built if needed."""
    lib = ctypes.CDLL(str(build_all()[name]))
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# csrc/hopper.cuh's codes for a tensor map that could not be made
ERR_NO_ENCODE, ERR_ENCODE = 9000, 10000


def check(rc: int, what: str) -> None:
    """Raise if a launch returned an error: a CUDA error code, or one of
    hopper.cuh's tensor-map codes."""
    if rc == ERR_NO_ENCODE:
        raise RuntimeError(f"{what}: CUDA offers no cuTensorMapEncodeTiled")
    if rc >= ERR_ENCODE:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a tensor map (CUresult "
                           f"{rc - ERR_ENCODE})")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
