#!/usr/bin/env python3
"""Where the packed training step's time goes, on the card.

    python3 scripts/profile_torch_train.py

Builds chip_smoke.py's training model at full width (frozen ESM2-650M hub
with its mlp head, trainable ESM2-35M struct-token tower, random weights
from a seed) and one packed batch (16 rows of 1024 tokens, 16 slots), warms
up, and then for the packed step and for the cached step prints:

- the step split into phases, timed with CUDA events around the same calls
  `OneProtModule.train_step_packed(_cached)` makes: hub forward, tower
  forward (with the heads and the loss), backward, optimizer (clip + Adam);
  the median over a few steps;
- the device kernels of one step under torch.profiler, summed by kind
  (flash-MHA forward, dq, dk/dv, GEMMs, optimizer, the rest) and by name,
  with the device's busy share of the step's wall time.

Then, from the same initial weights, 8 packed steps on the batch with Adam
at bench.py's 1e-3 (chip_smoke.py trains at SMOKE_LR), printing the loss
after each step.

Needs one CUDA card.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import SLOTS, build_module, make_packed_batch  # noqa: E402
from oneprot_tpu_torch.models import esm2  # noqa: E402
from oneprot_tpu_torch.models.encoders import (  # noqa: E402
    create_sequence_encoder,
    create_struct_token_encoder,
)
from oneprot_tpu_torch.train.module import OneProtModule  # noqa: E402
from oneprot_tpu_torch.train.optim import adam  # noqa: E402

TOP = 14
REPEATS = 5
BENCH_LR, LR_STEPS = 1e-3, 8
KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("flash-MHA forward", ("flash_mha_fwd",)),
    ("flash-MHA dq", ("flash_mha_bwd_dq",)),
    ("flash-MHA dk/dv", ("flash_mha_bwd_dkv",)),
    ("GEMMs", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_")),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("LayerNorm", ("layer_norm",)),
    ("GELU", ("gelu",)),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other (elementwise, casts, reductions, copies)"


def kernel_times(prof) -> dict:
    """Device time (ms) summed by kernel name: device events, without the
    ranges that annotations (the optimizer's "Optimizer.step#Adam.step")
    add to the device track over the kernels they enclose."""
    out = defaultdict(float)
    for evt in prof.events():
        if (evt.device_type == DeviceType.CUDA and not evt.is_user_annotation
                and not evt.name.startswith("Optimizer.")):
            out[evt.name] += evt.time_range.elapsed_us() / 1e3
    return out


def phased_step(module, batch, seq_pooled):
    """The calls of one train step, with a CUDA event between phases.
    Returns {phase: ms}."""
    dev = module.device
    t = lambda x, dt: torch.as_tensor(x, device=dev, dtype=dt)
    valid = t(batch["valid"], torch.float32)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    if seq_pooled is None:
        seq_feats, _ = module.model.encode_packed(
            t(batch["seq"]["ids"], torch.long),
            t(batch["seq"]["segment_ids"], torch.int32), SLOTS, "sequence")
    else:
        seq_feats = module.model.head_from_pooled(seq_pooled, "sequence")
    ev[1].record()
    mod_feats, _ = module.model.encode_packed(
        t(batch["mod"]["ids"], torch.long),
        t(batch["mod"]["segment_ids"], torch.int32), SLOTS, "struct_token")
    loss = module._packed_loss_value(mod_feats, seq_feats, valid.reshape(-1))
    ev[2].record()
    module.opt.zero_grad()
    loss.backward()
    ev[3].record()
    module.opt.step()
    ev[4].record()
    torch.cuda.synchronize()
    names = ("hub forward" if seq_pooled is None else "hub head (cached)",
             "tower forward + heads + loss", "backward", "optimizer")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def report(name: str, module, batch, seq_pooled) -> None:
    def step():
        if seq_pooled is None:
            return module.train_step_packed("struct_token", batch["seq"],
                                            batch["mod"], batch["valid"])
        return module.train_step_packed_cached("struct_token", seq_pooled,
                                               batch["mod"], batch["valid"])

    for _ in range(2):  # warm-up: cuBLAS handles, allocator
        step()[0].item()
    phases = [phased_step(module, batch, seq_pooled) for _ in range(REPEATS)]
    med = {k: float(np.median([p[k] for p in phases])) for k in phases[0]}
    total = sum(med.values())
    print(f"{name}: phases (median of {REPEATS}, CUDA events), "
          f"{total:.1f} ms in all", flush=True)
    for k, ms in med.items():
        print(f"  {k:34s} {ms:8.2f} ms  {100 * ms / total:5.1f}%", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        step()[0].item()
        wall_ms = (time.time() - t) * 1e3
    times = kernel_times(prof)
    busy = sum(times.values())
    print(f"{name}: one step under the profiler: wall {wall_ms:.1f} ms, "
          f"device busy {busy:.1f} ms = {100 * busy / wall_ms:.1f}% of wall",
          flush=True)
    by_kind = defaultdict(float)
    for kname, ms in times.items():
        by_kind[kind_of(kname)] += ms
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:48s} {ms:8.2f} ms  {100 * ms / busy:5.1f}%", flush=True)
    print(f"  top {TOP} kernels:", flush=True)
    for kname, ms in sorted(times.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"    {ms:8.2f} ms  {100 * ms / busy:5.1f}%  {kname[:110]}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    hub = create_sequence_encoder(proj_type="mlp")
    esm2.init_esm2_weights_(hub, torch.Generator(device="cuda").manual_seed(0))
    tower = create_struct_token_encoder()
    esm2.init_esm2_weights_(tower, torch.Generator(device="cuda").manual_seed(1))
    initial = [{k: v.clone() for k, v in m.state_dict().items()}
               for m in (hub, tower)]
    module = build_module(hub, tower)
    batch = make_packed_batch(np.random.RandomState(0))
    print(f"{torch.cuda.get_device_name(0)}; {int(batch['valid'].sum())} "
          f"proteins in 16 rows of 1024 tokens", flush=True)
    report("packed step", module, batch, None)
    pooled = module.encode_packed_pooled(
        "sequence", batch["seq"]["ids"], batch["seq"]["segment_ids"], SLOTS)
    report("cached step", module, batch, pooled)

    hub.load_state_dict(initial[0])
    tower.load_state_dict(initial[1])
    module = OneProtModule({"sequence": hub, "struct_token": tower},
                           optimizer=lambda: adam(BENCH_LR),
                           use_l1_regularization=True).init()
    losses = [module.train_step_packed("struct_token", batch["seq"],
                                       batch["mod"], batch["valid"])[0].item()
              for _ in range(LR_STEPS)]
    print(f"packed steps at Adam {BENCH_LR:g} from the initial weights: "
          f"losses " + ", ".join(f"{x:.4f}" for x in losses), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
