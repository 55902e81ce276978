"""The f32 flash-MHA kernels' CUDA source, compiled for the CPU and run.

The tiled forward (#1 f32) and dk/dv (#3 f32) kernels and the dq kernel
(#2 f32) of `csrc/flash_mha_f32.cuh` run on the card only; their speed and
what the GPU compiler makes of them need it (tests/test_torch_cuda.py).
Their indexing, tiling, segment-tile lists, ring of stages and epilogues
do not: here the header is compiled by the host's C++ compiler against
`tests/helpers/cuda_emu.h` (one std::thread per CUDA thread, barriers for
__syncthreads and the warp collectives, dynamic shared memory filled with
NaN), with its inline PTX replaced (cp.async by synchronous copies, the
SFU's exp2 by exp2f), and run on CPU tensors. Its outputs are held against
the plain versions at the kernels' bar (max rel err 1e-4, lse within 1e-5)
at every head dim 8-64, on L on and off the 32- and 64-row tiles, with and
without rotary, key bias and segment ids (contiguous, shuffled, and tails
of padding tiles), and the whole f32 chain (forward, dq, dk/dv) against
the JAX `mha_attention` in Pallas interpret mode and its jax.grad. Skips
where no C++20 compiler is found.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.kernels.flash_mha import mha_attention as jax_mha
from oneprot_tpu.models.esm2 import rotary_cos_sin as jax_rotary
from oneprot_tpu_torch.kernels import _build, flash_mha
from oneprot_tpu_torch.models.esm2 import rotary_cos_sin

REL_TOL, LSE_TOL = 1e-4, 1e-5  # the f32 kernels' bar on the card
HELPERS = Path(__file__).resolve().parent / "helpers"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the header's functions of inline PTX and their host stand-ins: the
# cp.async helpers as synchronous copies, the SFU's exp2 as exp2f
HOST_BODIES = {
    "void cp16(": "if (full) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);",
    "void cp4(": "std::memcpy(dst, src, 4);",
    "void cp_commit()": "",
    "void cp_wait_all()": "",
    "unsigned smem_addr(": "return 0;",
    "float ex2(": "return exp2f(x);",
}


def emulation_source(header: str) -> str:
    """flash_mha_f32.cuh for cuda_emu.h: the emulation's include, dynamic
    shared memory from the running block, `HOST_BODIES`."""
    src = header.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("extern __shared__ float4 smem4[];",
                      "float4* const smem4 = emu_dynamic_smem();")
    for signature, body in HOST_BODIES.items():
        start = src.index("{", src.index(signature))
        depth, end = 0, start
        for end in range(start, len(src)):
            depth += {"{": 1, "}": -1}.get(src[end], 0)
            if depth == 0:
                break
        src = src[:start] + "{ " + body + " }" + src[end + 1:]
    assert "asm" not in src and "__shared__ float4" not in src
    return src


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to build the emulation")
    out = tmp_path_factory.mktemp("f32_emu")
    (out / "f32_emu.cuh").write_text(emulation_source(
        (_build.CSRC / "flash_mha_f32.cuh").read_text()))
    lib = out / "f32_mha_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(out), "-I", str(HELPERS), "-o", str(lib),
                    str(HELPERS / "f32_mha_emu.cpp")], check=True,
                   capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.emu_flash_mha_fwd_f32.argtypes = [_P] * 11 + [_I] * 4 + [_F]
    so.emu_flash_mha_bwd_dq_f32.argtypes = [_P] * 13 + [_I] * 4 + [_F] * 2
    so.emu_flash_mha_bwd_dkv_f32.argtypes = [_P] * 12 + [_I] * 4 + [_F]
    return so


def _ptr(t):
    return None if t is None else t.data_ptr()


def emulated(so, q, k, v, dout, nh, **side):
    """The three kernels as the launchers drive them (`_kernel_args`' side
    inputs, `bwd_scales`, the forward's rotary pass into scratch), on CPU
    tensors: out, lse, dq, q_r, delta, dk, dv, and the forward's and
    dk/dv's shared memory in bytes."""
    B, L, hd = q.shape
    D = hd // nh
    bias, cos, sin, seg = (side.get(n) for n in ("bias", "rope_cos",
                                                  "rope_sin", "segment_ids"))
    bias_b = (None if bias is None
              else (bias.reshape(B, L) * flash_mha.LOG2E).contiguous())
    seg = None if seg is None else seg.to(torch.int32).contiguous()
    q_pre, dq_scale, dk_scale = flash_mha.bwd_scales(D)
    nan = lambda *shape: torch.full(shape, float("nan"))
    out, dq, q_r, dk, dv, q_rot, k_rot = (nan(B, L, hd) for _ in range(7))
    lse, delta = nan(B, nh, L), nan(B, nh, L)
    sides = (_ptr(bias_b), _ptr(cos), _ptr(sin), _ptr(seg))
    smem_fwd = so.emu_flash_mha_fwd_f32(_ptr(q), _ptr(k), _ptr(v), *sides,
                                        _ptr(out), _ptr(lse), _ptr(q_rot),
                                        _ptr(k_rot), B, L, nh, D, q_pre)
    so.emu_flash_mha_bwd_dq_f32(_ptr(q), _ptr(k), _ptr(v), _ptr(out),
                                _ptr(dout), *sides, _ptr(lse), _ptr(dq),
                                _ptr(q_r), _ptr(delta), B, L, nh, D, q_pre,
                                dq_scale)
    smem_dkv = so.emu_flash_mha_bwd_dkv_f32(
        _ptr(q_r), _ptr(k), _ptr(v), _ptr(dout), *sides, _ptr(lse),
        _ptr(delta), _ptr(dk), _ptr(dv), B, L, nh, D, dk_scale)
    return out, lse, dq, q_r, delta, dk, dv, smem_fwd, smem_dkv


def _case(B, L, nh, d, seed, rotary, bias, segments, shortest=2,
          shuffled=False):
    """numpy-seeded f32 q, k, v, dout (zero on padding rows) and side
    inputs; segments: 3 proteins a row (or their ids shuffled), padding -1."""
    rng = np.random.RandomState(seed)
    q, k, v, dout = (rng.randn(B, L, nh * d).astype(np.float32)
                     for _ in range(4))
    lens = rng.randint(max(L // shortest, 1), L + 1, size=B)
    valid = np.arange(L)[None, :] < lens[:, None]
    side = {}
    if bias:
        side["bias"] = torch.from_numpy(np.where(valid, 0.0, -1e9).astype(
            np.float32)[:, None, None, :])
    if rotary:
        side["rope_cos"], side["rope_sin"] = (
            t.float().contiguous() for t in rotary_cos_sin(L, d))
    if segments:
        seg = np.minimum(np.arange(L)[None, :] * 3 // L, 2).repeat(B, 0)
        if shuffled:
            seg = rng.randint(0, 5, size=(B, L))
        side["segment_ids"] = torch.from_numpy(
            np.where(valid, seg, -1).astype(np.int32))
    dout *= valid[..., None]
    return [torch.from_numpy(x) for x in (q, k, v, dout)], side


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


CASES = [  # every head dim: ragged L=200 (tails of padding tiles), all on
    (2, 200, 2, d, True, True, True, 4, False) for d in range(8, 72, 8)
] + [  # every head dim: L off the 32 and 64 grids, side inputs toggled
    (1, 37 + 30 * i, 2, d, i % 2 == 0, i % 3 != 0, i % 2 == 1, 2, False)
    for i, d in enumerate(range(8, 72, 8))
] + [  # shuffled ids: segment ranges overlap, tiles are still skipped
    (2, 160, 2, 16, True, True, True, 2, True),
    (1, 130, 2, 64, False, True, True, 2, True),
]


@pytest.mark.parametrize("B,L,nh,d,rotary,bias,segments,shortest,shuffled",
                         CASES)
def test_emulated_f32_kernels_match_plain(emu, B, L, nh, d, rotary, bias,
                                          segments, shortest, shuffled):
    """Forward (#1 f32), dq (#2 f32, prologue's q_r and delta) and dk/dv
    (#3 f32 on them) against mha_attention_plain, flash_mha_bwd_dq_plain
    and flash_mha_bwd_dkv_plain on the same inputs; every output finite
    (no NaN from unwritten shared memory)."""
    (q, k, v, dout), side = _case(B, L, nh, d, 7 * L + d, rotary, bias,
                                  segments, shortest, shuffled)
    out, lse, dq, q_r, delta, dk, dv, _, _ = emulated(emu, q, k, v, dout, nh,
                                                      **side)
    ref, ref_lse = flash_mha.mha_attention_plain(q, k, v, nh, **side)
    ref_dq, ref_qr, ref_delta = flash_mha.flash_mha_bwd_dq_plain(
        q, k, v, out, lse, dout, nh, **side)
    ref_dk, ref_dv = flash_mha.flash_mha_bwd_dkv_plain(
        q_r, k, v, dout, lse, delta, nh, **side)
    for name, got in (("out", out), ("lse", lse), ("dq", dq), ("dk", dk),
                      ("dv", dv)):
        assert torch.isfinite(got).all(), name
    for name, got, want in (("out", out, ref), ("dq", dq, ref_dq),
                            ("q_r", q_r, ref_qr), ("delta", delta, ref_delta),
                            ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert _rel(got, want) <= REL_TOL, f"{name}: {_rel(got, want)}"
    rows = ref_lse.abs() < 1e6  # a padding row's lse keeps no digits
    assert (lse - ref_lse).abs()[rows].max().item() <= LSE_TOL


@pytest.mark.parametrize("nh,d,rotary,segments", [
    (4, 16, True, True),     # the 8M debug hub's heads, packed rows
    (2, 64, False, False),   # bert_tiny: a key bias, no rotary
])
def test_emulated_f32_kernels_match_jax_interpret(emu, nh, d, rotary,
                                                  segments):
    """The emulated forward and backward chain against the JAX
    mha_attention (Pallas interpret mode) and its jax.grad, on the real
    rows, at the f32 bar (rtol 1e-4, atol 1e-5)."""
    B, L = 2, 96
    (q, k, v, g), side = _case(B, L, nh, d, d, False, True, segments)
    cos = sin = None
    if rotary:  # JAX's tables, handed to both
        cos, sin = (np.asarray(x) for x in jax_rotary(L, d, jnp.float32))
        side["rope_cos"], side["rope_sin"] = (torch.from_numpy(np.array(x))
                                              for x in (cos, sin))
    j = lambda x: None if x is None else jnp.asarray(np.asarray(x))
    seg = side.get("segment_ids")

    def jax_out(q_, k_, v_):
        return jax_mha(q_, k_, v_, nh, bias=j(side["bias"]), rope_cos=j(cos),
                       rope_sin=j(sin), segment_ids=j(seg), interpret=True)

    want = np.asarray(jax_out(j(q), j(k), j(v)))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_out(*a) * j(g)),
                          argnums=(0, 1, 2))(j(q), j(k), j(v))
    out, _, dq, _, _, dk, dv, _, _ = emulated(emu, q, k, v, g, nh, **side)
    real = side["bias"][:, 0, 0, :].numpy() == 0
    np.testing.assert_allclose(out.numpy()[real], want[real], rtol=1e-4,
                               atol=1e-5)
    for name, got, ref in zip("qkv", (dq, dk, dv), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("d,rotary,fwd_blocks,dkv_blocks", [
    (16, True, 3, 3),    # the debug hub's heads
    (64, False, 2, 2),   # bert_tiny's
    (64, True, 2, 2),
])
def test_shared_memory_lets_blocks_share_an_sm(emu, d, rotary, fwd_blocks,
                                               dkv_blocks):
    """The launches' dynamic shared memory (the tile list of L=1024
    included) leaves room for at least that many blocks on an SM of the
    H100: 228 KB an SM, 1 KB of it reserved a block, 227 KB a block."""
    (q, k, v, dout), side = _case(1, 1024, 1, d, 0, rotary, False, False)
    *_, smem_fwd, smem_dkv = emulated(emu, q, k, v, dout, 1, **side)
    per_sm = lambda smem: 228 * 1024 // (smem + 1024)
    assert smem_fwd <= 227 * 1024 and smem_dkv <= 227 * 1024
    assert per_sm(smem_fwd) >= fwd_blocks and per_sm(smem_dkv) >= dkv_blocks


def test_emulation_source_changes_only_the_inline_ptx():
    """What the emulation build changes in the header: the include, the
    dynamic shared memory and the bodies of the functions of inline PTX;
    the kernels compile as they are written."""
    header = (_build.CSRC / "flash_mha_f32.cuh").read_text()
    src = emulation_source(header)
    assert header.count("asm") == len(HOST_BODIES) - 1 and "asm" not in src
    for signature in HOST_BODIES:
        assert src.count(signature) == header.count(signature) == 1, signature
    for name in ("fwd_tiled", "dkv_tiled", "dq_kernel", "__syncthreads",
                 "__shfl_xor_sync", "__ballot_sync", "ex2(", "cp16("):
        assert src.count(name) == header.count(name), name
