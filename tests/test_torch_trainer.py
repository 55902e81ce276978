"""The port's trainer against the JAX package's, on the CPU at tiny sizes.

`Trainer.fit` of both packages over the same struct-token fixtures
(`generate_fixtures`, written to a temporary directory) from the same
weights: the JAX `OneProtModule.init` with a seed (deterministic, asserted
here), carried over by oneprot_tpu_torch.convert. Two epochs each, packed +
cache, unpacked + cache and cache off: every logged train loss, val/loss
and the validation features at the f32 bar of the step tests, the
retrieval metrics and train/steps exactly. Then the port's resume
semantics (after tests/test_train.py), its one deliberate difference from
the JAX trainer (the best value on resume), early stopping, the sanity
validation, the batch limits, the plateau scheduler and the refusals.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from oneprot_tpu.data.datamodule import OneProtDataModule as JaxDataModule
from oneprot_tpu.data.synthetic import generate_fixtures
from oneprot_tpu.train.scheduler import ReduceLROnPlateau as JaxPlateau
from oneprot_tpu.train.scheduler import get_learning_rate as jax_lr
from oneprot_tpu.train.trainer import Trainer as JaxTrainer
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data.datamodule import OneProtDataModule
from oneprot_tpu_torch.models import encoders, esm2
from oneprot_tpu_torch.train import optim, trainer as trainer_lib
from oneprot_tpu_torch.train.module import OneProtModule
from oneprot_tpu_torch.train.scheduler import (
    ReduceLROnPlateau,
    get_learning_rate,
)
from oneprot_tpu_torch.train.trainer import Trainer
from tests.helpers.tiny_models import patch_tiny_esm2

# f32 on the CPU, the bar of tests/test_torch_train_steps.py: the frameworks
# differ in summation order and the last ulp of erf, exp and LayerNorm
RTOL = 1e-4
WIDTH, LR = 32, 1e-3


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fx"))
    generate_fixtures(d, n_train=16, n_eval=8, modalities=["struct_token"])
    return d


def dm_kwargs(d, packed=False):
    """Bucket 64 (fixture lengths 20-60 + cls/eos): one shape unpacked;
    packed: 2 rows of 128 tokens, 4 slots."""
    return dict(
        modalities={"struct_token": {
            "dataset": {"data_dir": d, "filename": f"{d}/train_saprot.h5",
                        "max_length": 64},
            "batch_size": {"train": 4, "val": 4, "test": 4}}},
        buckets=[64], pack_sequences=packed, pack_rows=2, pack_row_len=128,
        pack_slots=4)


def jax_module(scheduler=None):
    patch_tiny_esm2()
    from oneprot_tpu.models.encoders import (
        create_sequence_encoder,
        create_struct_token_encoder,
    )
    from oneprot_tpu.train.module import OneProtModule as JaxModule
    from oneprot_tpu.train.optim import adam

    hub = create_sequence_encoder(
        model_name_or_path="facebook/esm2_t6_8M_UR50D", output_dim=WIDTH,
        proj_type="mlp", frozen=True, dtype="float32")
    tower = create_struct_token_encoder(
        model_name_or_path="facebook/esm2_t6_8M_UR50D", output_dim=WIDTH,
        dtype="float32")
    return JaxModule(components={"sequence": hub, "struct_token": tower},
                     optimizer=lambda: adam(LR), scheduler=scheduler,
                     loss_fn="CLIP", seed=0, frozen_param_dtype=None)


def initial_params(d):
    """The JAX init from the datamodule's example batches (as Trainer.setup
    makes it), as numpy, and the JAX encoders."""
    dm = JaxDataModule(**dm_kwargs(d))
    dm.setup()
    jm = jax_module()
    jm.init(dm.example_batches())
    return jax.tree.map(np.asarray, jm.state.params), jm.encoders


def port_module(params, jax_encoders, scheduler=None, device="cpu"):
    cfg = lambda n: esm2.Esm2Config(**dataclasses.asdict(jax_encoders[n].config))
    hub = encoders.SequenceEncoder(cfg("sequence"), WIDTH, proj_type="mlp",
                                   frozen=True, device=device,
                                   dtype=torch.float32)
    tower = encoders.StructTokenEncoder(cfg("struct_token"), WIDTH,
                                        device=device, dtype=torch.float32)
    module = OneProtModule({"sequence": hub, "struct_token": tower},
                           optimizer=lambda: optim.adam(LR), scheduler=scheduler,
                           frozen_param_dtype=None)
    module.model.load_state_dict(convert.oneprot_state_dict(params))
    return module


@pytest.fixture(scope="module")
def init(data_dir):
    return initial_params(data_dir)


def rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def sidecar(run_dir, name="last"):
    with open(os.path.join(run_dir, "checkpoints", f"{name}.metrics.json")) as f:
        return json.load(f)


def val_features(trainer, module, datamodule, jax_side):
    """(seq, mod) features of the val split through the trainer's own
    validation dispatch (cached when the trainer holds a cache)."""
    seqs, mods = [], []
    for seq_in, mod_in, modality, _ in datamodule.val_dataloader():
        cache = trainer._feature_cache
        if jax_side:
            params = module.state.params
            if cache is not None:
                s, m, _ = module.eval_step_cached(
                    params, modality, cache.get_pooled(module, seq_in), mod_in)
            else:
                s, m, _ = module.eval_step(params, modality, seq_in, mod_in)
        elif cache is not None:
            s, m, _ = module.eval_step_cached(
                modality, cache.get_pooled(module, seq_in), mod_in)
        else:
            s, m, _ = module.eval_step(modality, seq_in, mod_in)
        seqs.append(np.asarray(s, np.float32) if jax_side else s.numpy())
        mods.append(np.asarray(m, np.float32) if jax_side else m.numpy())
    return np.concatenate(seqs), np.concatenate(mods)


def test_jax_init_is_deterministic(data_dir, init):
    again, _ = initial_params(data_dir)
    for a, b in zip(jax.tree.leaves(init[0]), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("packed,cache", [(True, True), (False, True),
                                          (False, False)],
                         ids=["packed-cache", "unpacked-cache", "cache-off"])
def test_fit_matches_jax(data_dir, init, tmp_path, packed, cache):
    kw = dm_kwargs(data_dir, packed)
    jm = jax_module()
    jt = JaxTrainer(max_epochs=2, log_every_n_steps=1,
                    cache_frozen_features=cache, devices=1,
                    mesh={"data": 1, "model": 1},
                    default_root_dir=str(tmp_path / "jax"))
    jdm = JaxDataModule(**kw)
    jmet = jt.fit(jm, jdm)
    # Trainer.setup re-ran the seeded init: the port started from it too
    pm = port_module(*init)
    pt = Trainer(max_epochs=2, log_every_n_steps=1,
                 cache_frozen_features=cache, accelerator="cpu",
                 default_root_dir=str(tmp_path / "port"))
    pdm = OneProtDataModule(**kw)
    pmet = pt.fit(pm, pdm)

    jrows, prows = rows(tmp_path / "jax"), rows(tmp_path / "port")
    assert [r["step"] for r in prows] == [r["step"] for r in jrows]
    assert [sorted(r) for r in prows] == [sorted(r) for r in jrows]
    losses = [(p[k], j[k]) for p, j in zip(prows, jrows) for k in j
              if k.startswith(("train/loss", "val/loss"))]
    steps = 6 if packed else 8  # 3 packed or 4 padded batches an epoch
    assert pmet["train/steps"] == jmet["train/steps"] == steps
    # train/loss and train/loss_struct_token a step, val/loss and
    # val/loss_best a validation
    assert len(losses) == 2 * steps + 2 * 2
    got, want = np.array(losses).T
    np.testing.assert_allclose(got, want, rtol=RTOL)
    exact = {k for k in jmet if "_R@" in k or "median_rank" in k
             or k.startswith("cache/")}
    assert len(exact) >= 8
    assert {k: pmet[k] for k in exact} == {k: jmet[k] for k in exact}
    if cache:
        assert pt._feature_cache.hits == jt._feature_cache.hits > 0

    jseq, jmod = val_features(jt, jm, jdm, jax_side=True)
    pseq, pmod = val_features(pt, pm, pdm, jax_side=False)
    np.testing.assert_allclose(pseq, jseq, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(pmod, jmod, rtol=RTOL, atol=RTOL)
    # the ranks cannot flip: every off-diagonal logit stands further from
    # its row's (and column's) diagonal than the frameworks differ
    jl, pl = jseq @ jmod.T, pseq @ pmod.T
    diag = np.diag(jl)
    off = ~np.eye(len(jl), dtype=bool)
    gap = min(np.abs(jl - diag[:, None])[off].min(),
              np.abs(jl - diag[None, :])[off].min())
    assert gap > 10 * np.abs(pl - jl).max()
    assert gap > RTOL * np.abs(jl).max()


# ---------------------------------------------------------------------------
# resume (tests/test_train.py:94-160 for the JAX trainer)


def port_fit(d, init, run_dir, packed=False, ckpt_path=None, **kw):
    kw.setdefault("max_epochs", 1)
    tr = Trainer(log_every_n_steps=1, accelerator="cpu",
                 default_root_dir=str(run_dir), **kw)
    module = port_module(*init)
    metrics = tr.fit(module, OneProtDataModule(**dm_kwargs(d, packed)),
                     ckpt_path=ckpt_path)
    return tr, module, metrics


def test_resume_continues_step_and_epoch(data_dir, init, tmp_path):
    _, m1, met1 = port_fit(data_dir, init, tmp_path / "run1", packed=True)
    last = str(tmp_path / "run1" / "checkpoints" / "last")
    assert os.path.isfile(os.path.join(last, "state.pt"))
    _, m2, met2 = port_fit(data_dir, init, tmp_path / "run2", packed=True,
                           ckpt_path=last, max_epochs=2)
    assert met2["train/steps"] == 2 * met1["train/steps"]
    assert min(r["step"] for r in rows(tmp_path / "run2")) > met1["train/steps"]
    e1 = sidecar(tmp_path / "run1")["trainer/epoch"]
    assert sidecar(tmp_path / "run2")["trainer/epoch"] == e1 + 1
    # the optimizer state came back: Adam's step count continued
    opt_state = m2.opt.base.state_dict()["state"]
    assert {int(s["step"]) for s in opt_state.values()} == {int(met2["train/steps"])}
    # a completed run resumed with the same max_epochs trains nothing
    _, _, met3 = port_fit(data_dir, init, tmp_path / "run3", packed=True,
                          ckpt_path=last)
    assert met3["train/steps"] == met1["train/steps"]


def test_midepoch_checkpoint_replays_epoch(data_dir, init, tmp_path):
    mid = dict(val_check_interval=2, check_val_every_n_epoch=2)
    port_fit(data_dir, init, tmp_path / "run1", **mid)
    side1 = sidecar(tmp_path / "run1")
    assert side1["trainer/epoch_complete"] == 0.0
    last = str(tmp_path / "run1" / "checkpoints" / "last")
    port_fit(data_dir, init, tmp_path / "run2", ckpt_path=last, **mid)
    assert sidecar(tmp_path / "run2")["trainer/epoch"] == side1["trainer/epoch"]


def scripted(trainer, values):
    """Make `trainer.validate` return the scripted val/loss values in turn."""
    it = iter(values)
    trainer.validate = lambda *a, **k: {"val/loss": next(it)}


def test_best_survives_resume_unlike_jax(data_dir, init, tmp_path):
    """val/loss 1.0 then 2.0, resume from last, then 1.5. The JAX trainer
    seeds its best from last's val/loss (2.0) and overwrites `best` with
    the worse 1.5 (oneprot_tpu/train/trainer.py:260); the port keeps 1.0."""
    cbs = {"model_checkpoint": {"monitor": "val/loss"}}
    kw = dm_kwargs(data_dir)
    out = {}
    for name in ("jax", "port"):
        first, second = tmp_path / name / "a", tmp_path / name / "b"
        for run_dir, values, epochs, ckpt in (
                (first, [1.0, 2.0], 2, None),
                (second, [1.5], 3, str(first / "checkpoints" / "last"))):
            if name == "jax":
                tr = JaxTrainer(max_epochs=epochs, limit_train_batches=1,
                                devices=1, mesh={"data": 1, "model": 1},
                                default_root_dir=str(run_dir))
                module, dm = jax_module(), JaxDataModule(**kw)
            else:
                tr = Trainer(max_epochs=epochs, limit_train_batches=1,
                             accelerator="cpu", default_root_dir=str(run_dir))
                module, dm = port_module(*init), OneProtDataModule(**kw)
            scripted(tr, values)
            tr.fit(module, dm, ckpt_path=ckpt, callbacks=cbs)
        out[name] = (sidecar(first, "best")["val/loss"],
                     sidecar(second, "last")["val/loss_best"],
                     os.path.exists(second / "checkpoints" / "best.metrics.json"))
    assert out["jax"] == (1.0, 1.0, True)    # best overwritten by 1.5
    assert out["port"] == (1.0, 1.0, False)  # best left as it was
    assert sidecar(tmp_path / "port" / "b", "last")["checkpoint/best_value"] == 1.0


# ---------------------------------------------------------------------------
# controls


def test_early_stopping_mid_epoch(data_dir, init, tmp_path):
    tr = Trainer(max_epochs=3, min_epochs=0, val_check_interval=1,
                 accelerator="cpu", default_root_dir=str(tmp_path))
    scripted(tr, [1.0, 1.0, 1.0, 1.0])
    met = tr.fit(port_module(*init), OneProtDataModule(**dm_kwargs(data_dir)),
                 callbacks={"early_stopping": {"monitor": "val/loss",
                                               "patience": 0}})
    # the second validation does not improve: stop after its batch
    assert met["train/steps"] == 2


def test_sanity_validation_and_limits(data_dir, init, tmp_path):
    calls = []
    tr = Trainer(max_epochs=2, num_sanity_val_steps=1, limit_train_batches=1,
                 limit_val_batches=2, accelerator="cpu", log_every_n_steps=1,
                 default_root_dir=str(tmp_path))
    validate = tr.validate

    def counting(module, dm, split="val"):
        calls.append(tr.limit_val_batches)
        return validate(module, dm, split)

    tr.validate = counting
    seen = []
    dm = OneProtDataModule(**dm_kwargs(data_dir))
    module = port_module(*init)
    eval_step = module.eval_step_cached

    def counted(*a, **k):
        seen.append(1)
        return eval_step(*a, **k)

    module.eval_step_cached = counted
    met = tr.fit(module, dm)
    assert calls == [1, 2, 2]          # the sanity pass first, at its limit
    assert met["train/steps"] == 2     # one batch an epoch
    assert len(seen) == 2 * 2          # two val batches a validation
    assert min(r["step"] for r in rows(tmp_path)) == 1  # sanity logs nothing


def test_plateau_scheduler_matches_jax():
    """The plateau callback's learning rates on a scripted metric sequence,
    port (optimizer param_groups) against JAX (injected hyperparams)."""
    values = [1.0, 0.9, 0.95, 0.97, 0.85, 0.86, 0.87, 0.88, 0.9, 0.7]
    kw = dict(monitor="val/loss", factor=0.5, patience=1, min_lr=1e-4)
    jm = jax_module()
    ids = np.full((2, 8), 1, np.int32)
    ids[:, 0] = 0
    jm.init({"struct_token": (ids, ids)})
    pm = port_module(jax.tree.map(np.asarray, jm.state.params),
                     jm.encoders).init()
    js, ps = JaxPlateau(**kw), ReduceLROnPlateau(**kw)
    jlrs, plrs = [], []
    for v in values:
        js.on_validation_end(jm, {"val/loss": v})
        ps.on_validation_end(pm, {"val/loss": v})
        jlrs.append(jax_lr(jm.state.opt_state))
        plrs.append(get_learning_rate(pm.opt))
    assert len(set(plrs)) == 4  # 1e-3 halved three times
    np.testing.assert_allclose(plrs, jlrs, rtol=1e-6)


def test_module_scheduler_config_reaches_the_trainer(data_dir, init, tmp_path):
    tr = Trainer(max_epochs=2, limit_train_batches=1, accelerator="cpu",
                 default_root_dir=str(tmp_path))
    scripted(tr, [1.0, 1.0])
    module = port_module(*init, scheduler={"monitor": "val/loss",
                                           "patience": 0, "factor": 0.1})
    tr.fit(module, OneProtDataModule(**dm_kwargs(data_dir)))
    np.testing.assert_allclose(get_learning_rate(module.opt), LR * 0.1)
    assert [r["lr"] for r in rows(tmp_path) if "lr" in r] == [pytest.approx(LR * 0.1)]


# ---------------------------------------------------------------------------
# refusals


def test_refusals(init, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for acc in ("auto", "gpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(accelerator=acc)
    for kw in (dict(devices=2), dict(mesh={"data": 1, "model": 2}),
               dict(profiler="torch")):
        with pytest.raises(NotImplementedError, match="item 6"):
            Trainer(accelerator="cpu", **kw)
    # a module on the CPU for a trainer on the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    tr = Trainer(accelerator="gpu")
    assert tr.device == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="on cpu"):
        tr.fit(port_module(*init), None)
    # the LoRA adapter export is ported: a module without LoRA writes none
    peft = trainer_lib.PeftCheckpoint(dirpath="unused", num_layers=2)
    assert peft.on_validation_end(port_module(*init), {"val/loss": 1.0}) is None
