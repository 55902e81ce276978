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
                      [_VOID_P] * 9 + [_INT] * 4 + [ctypes.c_float, _VOID_P]),
    "gelu_quant": ("oneprot_gelu_quant",
                   [_VOID_P, _INT, _VOID_P, _VOID_P, ctypes.c_longlong, _INT,
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


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
