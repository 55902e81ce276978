"""One rank of a gloo world on the CPU, for tests/test_torch_distributed.py
and tests/test_torch_tensor_parallel.py.

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


# -- tensor parallelism: a model axis of 2 ----------------------------------

TP_WIDTH = 16
TP_LORA = dict(rank=4, alpha=8.0, dropout=0.0)


def tp_module(saved: dict, tp, lr: float = 1e-4):
    """tests/test_torch_tensor_parallel.py's module (a frozen LoRA hub, a
    trainable struct-token tower and a frozen text tower, f32, L1 on) as
    model rank tp[1]'s shard of tp[0], from the full converted JAX state
    `saved` holds."""
    from oneprot_tpu_torch.core import partitioning
    from oneprot_tpu_torch.models import bert, encoders, esm2
    from oneprot_tpu_torch.train import optim
    from oneprot_tpu_torch.train.module import OneProtModule

    cfg = saved["configs"]
    kw = dict(tp=tuple(tp), device="cpu", dtype=torch.float32)
    hub = encoders.SequenceEncoder(
        esm2.Esm2Config(**cfg["sequence"]), TP_WIDTH, proj_type="mlp",
        frozen=True, lora=esm2.LoraConfig(**TP_LORA), **kw)
    tower = encoders.StructTokenEncoder(
        esm2.Esm2Config(**cfg["struct_token"]), TP_WIDTH, **kw)
    text = encoders.TextEncoder(bert.BertConfig(**cfg["text"]), TP_WIDTH,
                                frozen=True, **kw)
    module = OneProtModule(
        {"sequence": hub, "struct_token": tower, "text": text},
        optimizer=lambda: optim.adam(lr), use_l1_regularization=True,
        frozen_param_dtype=None)
    module.model.load_state_dict(partitioning.shard_state_dict(
        saved["state"], tp[1], tp[0], partitioning.layout_of(module.model)))
    return module


def tp_steps(module, inp, rank: int, world: int) -> list:
    """Two packed struct_token steps and one unpacked text step on this
    data rank's block of the global batches; the global losses."""
    losses = []
    for i in range(inp["ids"].shape[0]):
        seq, mod = ({"ids": _block(inp[a][i], rank, world),
                     "segment_ids": _block(inp[b][i], rank, world)}
                    for a, b in (("ids", "seg"), ("st_ids", "st_seg")))
        loss, _ = module.train_step_packed(
            "struct_token", seq, mod, _block(inp["valid"][i], rank, world))
        losses.append(float(loss))
    loss, _ = module.train_step("text", _block(inp["text_seq"], rank, world),
                                _block(inp["text_ids"], rank, world))
    return losses + [float(loss)]


def _tp_layers(inp) -> dict:
    """Column- and row-parallel layers (and LoRA's) against one unsharded
    Dense pair, forward and backward, on this model rank."""
    import torch.nn.functional as F

    from oneprot_tpu_torch.models import esm2
    from oneprot_tpu_torch.models.layers import (
        ColumnParallelDense,
        Dense,
        RowParallelDense,
    )

    m, r = mesh.model_world()
    kw = dict(device="cpu", dtype=torch.float32)
    w1, b1, w2, b2 = (torch.from_numpy(inp[k]) for k in ("w1", "b1", "w2",
                                                          "b2"))
    F_, H = w1.shape
    out = {}

    def run(fc1, fc2, lora=None):
        x = torch.from_numpy(inp["x"]).requires_grad_(True)
        y = fc2(F.gelu(fc1(x)))
        (y * torch.from_numpy(inp["dy"])).sum().backward()
        return y, x.grad

    full1, full2 = Dense(H, F_, **kw), Dense(F_, H, **kw)
    col = ColumnParallelDense(H, F_, tp=(m, r), **kw)
    row = RowParallelDense(F_, H, tp=(m, r), **kw)
    with torch.no_grad():
        for mod, w, b in ((full1, w1, b1), (full2, w2, b2)):
            mod.weight.copy_(w)
            mod.bias.copy_(b)
        col.weight.copy_(w1.chunk(m, 0)[r])
        col.bias.copy_(b1.chunk(m, 0)[r])
        row.weight.copy_(w2.chunk(m, 1)[r])
        row.bias.copy_(b2)
    for name, (a, b) in (("full", (full1, full2)), ("tp", (col, row))):
        y, gx = run(a, b)
        out[f"layers/{name}/y"], out[f"layers/{name}/gx"] = (
            y.detach().numpy(), gx.numpy())
        for tag, mod in (("fc1", a), ("fc2", b)):
            out[f"layers/{name}/{tag}_gw"] = mod.weight.grad.numpy()
            out[f"layers/{name}/{tag}_gb"] = mod.bias.grad.numpy()
    # a row-parallel layer on a whole input takes its block of it
    whole = RowParallelDense(H, H, tp=(m, r), input_is_parallel=False, **kw)
    with torch.no_grad():
        whole.weight.copy_(w2[:, :H].chunk(m, 1)[r])
        whole.bias.copy_(b2)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = whole(x)
    (y * torch.from_numpy(inp["dy"])).sum().backward()
    out["layers/scatter/y"], out["layers/scatter/gx"] = (y.detach().numpy(),
                                                         x.grad.numpy())
    # LoRA column-parallel: lora_B split, lora_A's gradient a partial sum
    lora = esm2.LoraConfig(**TP_LORA)
    parts = {}
    for name, tp in (("full", (1, 0)), ("tp", (m, r))):
        layer = esm2.LoraDense(H, F_, lora, 0, tp=tp, **kw)
        with torch.no_grad():
            layer.weight.copy_(w1.chunk(tp[0], 0)[tp[1]])
            layer.bias.copy_(b1.chunk(tp[0], 0)[tp[1]])
            layer.lora_A.copy_(torch.from_numpy(inp["lora_a"]))
            layer.lora_B.copy_(torch.from_numpy(inp["lora_b"]).chunk(
                tp[0], 0)[tp[1]])
        x = torch.from_numpy(inp["x"]).requires_grad_(True)
        y = layer(x)
        (y * torch.from_numpy(inp["dy1"]).chunk(tp[0], -1)[tp[1]]).sum(
        ).backward()
        grad_a = layer.lora_A.grad.clone()
        if tp[0] > 1:
            collectives.model_sum_([grad_a])
        parts[name] = (y.detach(), x.grad, grad_a, layer.lora_B.grad)
    for i, key in enumerate(("y", "gx", "ga", "gb")):
        out[f"lora/full/{key}"] = parts["full"][i].numpy()
        out[f"lora/tp/{key}"] = parts["tp"][i].numpy()
    # Megatron's f and g
    x = torch.full((3,), float(r + 1), requires_grad=True)
    collectives.copy_to_model_group(x).mul(float(r + 1)).sum().backward()
    out["f/grad"] = x.grad.numpy()
    out["g/value"] = collectives.reduce_from_model_group(
        torch.full((3,), float(r + 1))).numpy()
    return out


def tp_fit(module, dm_kwargs: dict, run_dir: str, deterministic: bool,
           noise_rank=None) -> dict:
    """`Trainer.fit` of `module` (1 epoch, TP_FIT_BATCHES batches, one
    validation batch) with `deterministic`. With `noise_rank`, a gradient
    hook adds noise drawn from that number to the struct-token tower's
    embedding table (replicated), as atomics part the ranks' sums on the
    card. Returns whether deterministic algorithms were on at each forward,
    and the noisy gradients the hook made."""
    from oneprot_tpu_torch.data.datamodule import OneProtDataModule
    from oneprot_tpu_torch.train.trainer import Trainer

    seen, noisy = [], []
    module.model.register_forward_pre_hook(
        lambda mod, args: seen.append(torch.are_deterministic_algorithms_enabled()))
    if noise_rank is not None:
        gen = torch.Generator().manual_seed(1000 + noise_rank)
        table = module.encoders["struct_token"].transformer.embed_tokens.weight

        def hook(grad):
            noisy.append(grad + 1e-3 * torch.randn(grad.shape, generator=gen))
            return noisy[-1]

        table.register_hook(hook)
    m = mesh.model_world()[0]
    trainer = Trainer(max_epochs=1, limit_train_batches=TP_FIT_BATCHES,
                      limit_val_batches=1, log_every_n_steps=1,
                      accelerator="cpu", default_root_dir=run_dir,
                      deterministic=deterministic,
                      mesh={"data": -1, "model": m} if m > 1 else None)
    trainer.fit(module, OneProtDataModule(**dm_kwargs))
    return {"deterministic": seen, "noisy": noisy,
            "after": torch.are_deterministic_algorithms_enabled()}


TP_FIT_BATCHES = 3


def int8_tp_module(saved: dict, tp, lr: float = 1e-4):
    """A frozen int8 hub (the float hub of `saved` quantized; biases drawn
    so that the bias placement shows) beside the trainable struct-token
    tower, as model rank tp[1]'s shard of tp[0]: the hub whole, the tower
    split."""
    from oneprot_tpu_torch.core import partitioning
    from oneprot_tpu_torch.models import encoders, esm2
    from oneprot_tpu_torch.train import optim
    from oneprot_tpu_torch.train.module import OneProtModule

    cfg = saved["configs"]
    kw = dict(tp=tuple(tp), device="cpu", dtype=torch.float32)
    hub = encoders.SequenceEncoder(esm2.Esm2Config(**cfg["sequence"]),
                                   TP_WIDTH, proj_type="mlp", frozen=True,
                                   quant_int8=True, **kw)
    tower = encoders.StructTokenEncoder(
        esm2.Esm2Config(**cfg["struct_token"]), TP_WIDTH, **kw)
    module = OneProtModule({"sequence": hub, "struct_token": tower},
                           optimizer=lambda: optim.adam(lr),
                           frozen_param_dtype=None)
    gen = torch.Generator().manual_seed(5)
    state = saved["state"]
    full = {k: v for k, v in state.items()
            if k.startswith("encoders.struct_token.")}
    for name, t in esm2.quantize_esm2_int8_tree(
            {k: v for k, v in state.items()
             if k.startswith("encoders.sequence.")
             and "lora_" not in k}).items():
        if name.endswith(".bias") and ".layers." in name:
            t = torch.randn(t.shape, generator=gen) * 0.02
        full[name] = t
    module.model.load_state_dict(partitioning.shard_state_dict(
        full, tp[1], tp[0], partitioning.layout_of(module.model)))
    return module


def int8_hub_rows() -> torch.Tensor:
    """The rows the int8 hubs embed: 3 proteins of the hub's alphabet."""
    rng = np.random.RandomState(17)
    ids = np.full((3, 24), 1, np.int64)
    for r, n in enumerate((24, 17, 9)):
        ids[r, :n] = rng.randint(4, 24, size=n)
        ids[r, 0], ids[r, n - 1] = 0, 2
    return torch.from_numpy(ids)


def _int8_and_f1(inp, saved, tp) -> dict:
    """At data 1 x model 2: the int8 hub's pooled features and a checkpoint
    of its module; then `Trainer.fit` with rank-dependent gradient noise
    on a replicated table (deterministic algorithms off) and without it
    (on), each rank's replicated parameters as held after."""
    from oneprot_tpu_torch.core import partitioning
    from oneprot_tpu_torch.train import checkpoint as ckpt

    out = {}
    module = int8_tp_module(saved, tp).init()
    hub = module.encoders["sequence"].eval()
    with torch.no_grad():
        out["int8/pooled"] = hub.backbone_pooled(int8_hub_rows()).numpy()
    out["int8/hub_bytes"] = np.array(sum(
        t.numel() * t.element_size() for t in hub.transformer.buffers()))
    root = str(inp["ckpt_dir"])
    ckpt.CheckpointManager(os.path.join(root, "int8_tp2")).on_validation_end(
        module, {"val/loss_best": 1.0})
    dm = json.loads(str(inp["dm"]))
    for run, noise in (("noisy", tp[1]), ("clean", None)):
        module = tp_module(saved, tp)
        res = tp_fit(module, dm, os.path.join(root, f"f1_{run}"),
                     deterministic=noise is None, noise_rank=noise)
        out[f"f1/{run}/deterministic"] = np.array(res["deterministic"])
        out[f"f1/{run}/after"] = np.array(res["after"])
        out[f"f1/{run}/step"] = np.array(module.step)
        if res["noisy"]:
            out[f"f1/{run}/noisy_grad"] = res["noisy"][0].numpy()
        layout = partitioning.layout_of(module.model)
        full = partitioning.gather_state_dict(module.model.state_dict(),
                                              layout)
        for name, p in module.model.named_parameters():
            if p.requires_grad:
                out[f"f1/{run}/param/{name}"] = full[name].numpy().copy()
                if name not in layout:
                    out[f"f1/{run}/held/{name}"] = p.detach().numpy().copy()
    return out


def case_tp(rank: int, world: int, inp) -> dict:
    """A model axis of 2 over `world` ranks (data world / 2): the layers
    (at data 1), the module's steps on this data rank's block, the full
    trainable parameters and the replicated ones as held, the gathered
    eval features, the loaders' first batches and the step seed; at data
    2 also `case_losses` over the data group; at data 1 the checkpoints
    both ways and the peft export."""
    from oneprot_tpu_torch.core import partitioning
    from oneprot_tpu_torch.data.datamodule import OneProtDataModule
    from oneprot_tpu_torch.models.esm2 import LoraDense
    from oneprot_tpu_torch.train import checkpoint as ckpt
    from oneprot_tpu_torch.train.metrics import gather_features

    mesh.check_mesh({"data": -1, "model": 2})
    tp = mesh.model_world()
    n, dr = mesh.data_world()
    out = {"tp": np.array(tp), "data": np.array((n, dr))}
    saved = torch.load(str(inp["state"]), weights_only=False)
    if n == 1:
        out.update(_tp_layers(inp))
        out.update(_int8_and_f1(inp, saved, tp))
    else:
        losses = case_losses(dr, n, {k[len("loss_"):]: v for k, v in
                                     inp.items() if k.startswith("loss_")})
        out.update({f"dloss/{k}": v for k, v in losses.items()})
    module = tp_module(saved, tp).init()
    out["losses"] = np.array(tp_steps(module, inp, dr, n))
    out["seed"] = np.array(next(
        mod.dropout_seed for mod in module.model.modules()
        if isinstance(mod, LoraDense)))
    layout = partitioning.layout_of(module.model)
    full = partitioning.gather_state_dict(module.model.state_dict(), layout)
    for name, p in module.model.named_parameters():
        if module.mask[name]:
            out[f"param/{name}"] = full[name].numpy().copy()
            if name not in layout:
                out[f"held/{name}"] = p.detach().numpy().copy()
    seq_f, mod_f, loss = module.eval_step("text",
                                          _block(inp["eval_seq"], dr, n),
                                          _block(inp["eval_text"], dr, n))
    out["eval/seq"], out["eval/mod"] = gather_features(seq_f), gather_features(
        mod_f)
    out["eval/loss"] = np.array(float(loss))
    dm = OneProtDataModule(**json.loads(str(inp["dm"])))
    dm.setup()
    out["loader"] = next(iter(dm.train_dataloader()))["struct_token"][0]
    if n == 1:
        root = str(inp["ckpt_dir"])
        ckpt.CheckpointManager(os.path.join(root, "tp2")).on_validation_end(
            module, {"val/loss_best": 1.0})
        ckpt.PeftCheckpoint(os.path.join(root, "tp2", "peft"),
                            num_layers=2).on_validation_end(
            module, {"val/loss": 1.0})
        # the one-process checkpoint, restored as this rank's shard
        other = tp_module(saved, tp).init()
        ckpt.load_state(other, os.path.join(root, "tp1", "last"))
        out["restored/step"] = np.array(other.step)
        # copies: the step below moves the parameters in place
        for k, v in other.model.state_dict().items():
            out[f"restored/{k}"] = v.numpy().copy()
        for i, s in other.opt.base.state_dict()["state"].items():
            for key in ckpt.MOMENTS:
                out[f"restored_opt/{i}/{key}"] = s[key].numpy().copy()
        out["restored/losses"] = np.array(tp_steps(other, inp, dr, n))
    return out


CASES = {"losses": case_losses, "steps": case_steps, "fit": case_fit,
         "tp": case_tp}


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
