#!/usr/bin/env python3
"""Is the packed-cached training step deterministic on the card?

    python3 scripts/probe_determinism.py

Builds `chip_smoke.py`'s training model at full width (the frozen 650M hub
with its mlp head, the 35M struct-token tower; random weights from a
seed) and one packed batch of 16 rows of 1024 tokens, then runs the
forward and backward of `train_step_packed_cached` (no optimizer step)
five times on the same weights and inputs and prints, for each repeat,
whether the loss, the tower's features and every gradient equal the first
repeat's bit for bit, naming the parameters whose gradients differ and by
how much. Then the same with `torch.use_deterministic_algorithms(True)`.
Needs one CUDA card.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPEATS = 5


def one_pass(module, pooled, batch) -> tuple:
    module._begin_step()
    valid = module._tensor(batch["valid"], torch.float32)
    seq = module.model.head_from_pooled(pooled, "sequence")
    mod, _ = module.model.encode_packed(
        module._tensor(batch["mod"]["ids"], torch.long),
        module._tensor(batch["mod"]["segment_ids"], torch.int32),
        valid.shape[1], "struct_token")
    loss = module._packed_loss_value(mod, seq, valid.reshape(-1))
    module.opt.zero_grad()
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in
             module.model.named_parameters() if p.grad is not None}
    return loss.detach().clone(), mod.detach().clone(), grads


def report(module, pooled, batch, what: str) -> None:
    first = one_pass(module, pooled, batch)
    for r in range(1, REPEATS):
        loss, feats, grads = one_pass(module, pooled, batch)
        differ = {n: float((g - first[2][n]).abs().max())
                  for n, g in grads.items() if not torch.equal(g, first[2][n])}
        print(f"{what}, repeat {r}: loss equal {torch.equal(loss, first[0])}, "
              f"tower features equal {torch.equal(feats, first[1])}, "
              f"{len(differ)} of {len(grads)} gradients differ"
              + (": " + ", ".join(f"{n} {d:.2e}" for n, d in
                                  sorted(differ.items())[:12]) if differ
                 else ""), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_determinism: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from oneprot_tpu_torch.kernels import _build

    cs.exact_f32()
    _build.build_all()
    module, batches = cs.gloo_setup()
    batch = batches[0]
    pooled = module.encode_packed_pooled(
        "sequence", batch["seq"]["ids"], batch["seq"]["segment_ids"], cs.SLOTS)
    report(module, pooled, batch, "default")
    torch.use_deterministic_algorithms(True, warn_only=True)
    report(module, pooled, batch, "use_deterministic_algorithms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
