"""One rank of a gloo world on the CPU, for tests/test_torch_distributed.py.

    python -m tests.helpers.torch_dist_child CASE RANK WORLD RENDEZVOUS IN OUT

Joins the world through `core.mesh.init_distributed` (a file:// rendezvous),
reads the case's inputs from the npz `IN` (written by the parent), runs the
case and writes its results to `OUT` (an npz, or a json for the trainer
cases). Imports the port, numpy and torch only: the parent computes the
JAX oracle.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np
import torch

from oneprot_tpu_torch.core import collectives, mesh

WIDTH = 32
SLOTS = 4


@contextlib.contextmanager
def group_of_one(directory):
    """A gloo process group of this process alone (a file:// rendezvous in
    `directory`), left when the block ends."""
    os.makedirs(directory, exist_ok=True)
    mesh.init_distributed(f"file://{directory}/rendezvous", num_processes=1,
                          process_id=0, accelerator="cpu")
    try:
        yield
    finally:
        mesh.shutdown_distributed()


def _block(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    """This rank's block of a global array's rows."""
    b = x.shape[0] // world
    return np.ascontiguousarray(x[rank * b:(rank + 1) * b])


def _local(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    return torch.from_numpy(_block(x, rank, world))


def case_losses(rank: int, world: int, inp) -> dict:
    """Every loss's share, and its gradient on this rank's features; at a
    world of 2 the collectives themselves."""
    from oneprot_tpu_torch.losses.clip import clip_loss, clip_loss_masked
    from oneprot_tpu_torch.losses.siglip import siglip_loss, siglip_loss_masked

    valid = _local(inp["valid"], rank, world)
    fns = {
        "clip_local": lambda m, s: clip_loss(m, s, axis_name="data"),
        "clip_global": lambda m, s: clip_loss(m, s, axis_name="data",
                                              local_loss=False),
        "clip_masked": lambda m, s: clip_loss_masked(m, s, valid,
                                                     axis_name="data"),
        "siglip_bidir": lambda m, s: siglip_loss(m, s, axis_name="data"),
        "siglip_chain": lambda m, s: siglip_loss(m, s, axis_name="data",
                                                 bidir=False),
        "siglip_masked_bidir": lambda m, s: siglip_loss_masked(
            m, s, valid, axis_name="data"),
        "siglip_masked_chain": lambda m, s: siglip_loss_masked(
            m, s, valid, axis_name="data", bidir=False),
    }
    out = {}
    for name, fn in fns.items():
        m = _local(inp["mod"], rank, world).requires_grad_(True)
        s = _local(inp["seq"], rank, world).requires_grad_(True)
        loss = fn(m, s)
        loss.backward()
        out[f"{name}/loss"] = loss.detach().numpy()
        out[f"{name}/grad_mod"] = m.grad.numpy()
        out[f"{name}/grad_seq"] = s.grad.numpy()
    if world == 2:
        w = torch.from_numpy(inp["weights"][rank])  # [2 * b, D]
        x = _local(inp["mod"], rank, world).requires_grad_(True)
        gathered = collectives.all_gather_with_grad(x)
        (gathered * w).sum().backward()
        out["gather/value"] = gathered.detach().numpy()
        out["gather/grad"] = x.grad.numpy()
        x = _local(inp["mod"], rank, world).requires_grad_(True)
        shifted = collectives.ring_shift(x, +1)
        (shifted * w[:x.shape[0]]).sum().backward()
        out["shift/value"] = shifted.detach().numpy()
        out["shift/grad"] = x.grad.numpy()
        rows = torch.from_numpy(inp["mod"][:3 + 2 * rank])  # 3 and 5 rows
        out["gather_rows"] = collectives.gather_rows(rows).numpy()
        out["mean"] = collectives.mean_across(torch.tensor(float(rank))).numpy()
        out["stamp"] = np.array(collectives.broadcast_str(f"stamp-{rank}"))
    return out


def tiny_module(state_path: str, lr: float = 1e-4):
    """The tests' tiny frozen hub + tower (f32, L1 on) from a converted
    JAX state dict."""
    from oneprot_tpu_torch.models import encoders, esm2
    from oneprot_tpu_torch.train import optim
    from oneprot_tpu_torch.train.module import OneProtModule

    saved = torch.load(state_path, weights_only=False)
    cfg = {k: esm2.Esm2Config(**v) for k, v in saved["configs"].items()}
    hub = encoders.SequenceEncoder(cfg["sequence"], WIDTH, proj_type="mlp",
                                   frozen=True, device="cpu",
                                   dtype=torch.float32)
    tower = encoders.StructTokenEncoder(cfg["struct_token"], WIDTH,
                                        device="cpu", dtype=torch.float32)
    module = OneProtModule({"sequence": hub, "struct_token": tower},
                           optimizer=lambda: optim.adam(lr),
                           use_l1_regularization=True,
                           loss_fn=saved.get("loss_fn", "CLIP"),
                           frozen_param_dtype=None)
    module.model.load_state_dict(saved["state"])
    return module


def _trainable(module) -> dict:
    return {f"param/{k}": p.detach().numpy().copy()
            for k, p in module.model.named_parameters() if p.requires_grad}


def case_steps(rank: int, world: int, inp) -> dict:
    """5 packed, 5 packed-cached (through the feature cache, rank 0's
    warmed with the first batch, so that a hit on one rank meets a miss on
    the other) and 5 unpacked steps on this rank's share of the global
    batches; the final trainable parameters of each; then a frozen-digest
    mismatch at init."""
    from oneprot_tpu_torch.train.feature_cache import FrozenFeatureCache

    state = str(inp["state"])
    out = {}
    n = inp["ids"].shape[0]
    for kind in ("packed", "cached", "unpacked"):
        module = tiny_module(state).init()
        cache = FrozenFeatureCache()
        if kind == "cached" and rank == 0:
            cache.get_pooled_packed(module, *(_block(inp[k][0], rank, world)
                                              for k in ("ids", "seg", "valid")))
        losses = []
        for i in range(n):
            if kind == "unpacked":
                loss, _ = module.train_step(
                    "struct_token", _block(inp["seq_rows"][i], rank, world),
                    _block(inp["st_rows"][i], rank, world))
            else:
                ids, seg, valid = (_block(inp[k][i], rank, world)
                                   for k in ("ids", "seg", "valid"))
                mod = {"ids": _block(inp["st_ids"][i], rank, world),
                       "segment_ids": _block(inp["st_seg"][i], rank, world)}
                if kind == "packed":
                    loss, _ = module.train_step_packed(
                        "struct_token", {"ids": ids, "segment_ids": seg}, mod,
                        valid)
                else:
                    pooled = cache.get_pooled_packed(module, ids, seg, valid)
                    loss, _ = module.train_step_packed_cached(
                        "struct_token", pooled, mod, valid)
            losses.append(float(loss))
        out[f"{kind}/losses"] = np.array(losses)
        out[f"{kind}/hits"] = np.array(cache.hits)
        out.update({f"{kind}/{k}": v for k, v in _trainable(module).items()})
    module = tiny_module(state)
    if rank == 1:  # a frozen hub weight of its own
        with torch.no_grad():
            module.encoders["sequence"].transformer.embed_tokens.weight[0] += 1
    try:
        module.init()
        out["mismatch"] = np.array("")
    except ValueError as e:
        out["mismatch"] = np.array(str(e))
    return out


def case_fit(rank: int, world: int, inp) -> dict:
    """`Trainer.fit` (2 epochs, unpacked + cache, validation each epoch),
    the gathered val features of its final weights, a resume for a third
    epoch; then `trainer=ddp_sim` through `cli.train.main` and
    `cli.collect_embeddings.main`."""
    from oneprot_tpu_torch.cli import collect_embeddings as cli_collect
    from oneprot_tpu_torch.cli import train as cli_train
    from oneprot_tpu_torch.data.datamodule import OneProtDataModule
    from oneprot_tpu_torch.train.metrics import gather_features
    from oneprot_tpu_torch.train.trainer import Trainer

    cfg = json.loads(str(inp["cfg"]))
    run = cfg["run_dir"]
    out = {}
    tr = Trainer(max_epochs=2, log_every_n_steps=1, accelerator="cpu",
                 devices=world, default_root_dir=run)
    module = tiny_module(cfg["state"])
    dm = OneProtDataModule(**cfg["dm"])
    out["fit"] = tr.fit(module, dm)
    seqs, mods = [], []
    for seq_in, mod_in, modality, _ in dm.val_dataloader():
        s, m, _ = module.eval_step(modality, seq_in, mod_in)
        seqs.append(gather_features(s))
        mods.append(gather_features(m))
    out["val_seq"] = np.concatenate(seqs).tolist()
    out["val_mod"] = np.concatenate(mods).tolist()
    out["validate"] = tr.validate(module, dm)
    out["params"] = {k: v.tolist() for k, v in _trainable(module).items()}
    again = Trainer(max_epochs=3, log_every_n_steps=1, accelerator="cpu",
                    default_root_dir=run)
    resumed = tiny_module(cfg["state"])
    out["resumed"] = again.fit(resumed, OneProtDataModule(**cfg["dm"]),
                               ckpt_path=os.path.join(run, "checkpoints",
                                                      "last"))
    out["resumed_step"] = resumed.step
    metrics = cli_train.main(cfg["cli"])
    out["cli"] = {k: float(v) for k, v in metrics.items()}
    runs = os.path.join(cfg["cli_logs"], "train", "runs")
    out["cli_runs"] = sorted(os.listdir(runs))
    out["collect"] = cli_collect.main(cfg["collect"], device="cpu")
    return out


CASES = {"losses": case_losses, "steps": case_steps, "fit": case_fit}


def main() -> int:
    case, rank, world, rendezvous, inp_path, out_path = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh.init_distributed(f"file://{rendezvous}", num_processes=world,
                          process_id=rank, accelerator="cpu", timeout_s=240)
    inp = dict(np.load(inp_path, allow_pickle=False))
    result = CASES[case](rank, world, inp)
    collectives.barrier()
    mesh.shutdown_distributed()
    if out_path.endswith(".json"):
        with open(out_path, "w") as f:
            json.dump(result, f, default=float)
    else:
        np.savez(out_path, **result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
