"""Data-parallel training of the port over torch.distributed, against the
JAX package, on the CPU.

Gloo worlds of 2, 3 and 4 ranks are spawned (`tests/helpers/
torch_dist_child.py`, a file:// rendezvous under the test's temporary
directory, so that no port is shared with another worker); each child
imports the port only, and the parent computes the JAX oracle meanwhile on
the conftest's 8-device CPU mesh. Each world runs under a time limit and
its children are killed when it passes.

- The collectives (all_gather_with_grad, ring_shift, gather_rows, the
  mean, the stamp broadcast), values and gradients.
- `clip_loss` (local and global) and the SigLIP ring (plain and masked,
  bidir on and off) against the JAX functions under `shard_map` at W = 2,
  3, 4; the distributed `clip_loss_masked`, with a different valid count
  on every rank, against the JAX `clip_loss_masked` on the concatenated
  pack. A rank returns its share: the mean of the shares is the JAX loss,
  and a rank's feature gradient is world x the JAX gradient's rows (the
  optimizer's all-reduce-mean divides by the world).
- 2 ranks x 5 packed, packed-cached (a cache hit on one rank, a miss on
  the other) and unpacked steps against the JAX `OneProtModule` on the
  global batches (per-process batches: W ranks x b rows against the JAX
  step on W * b), ranks bit-identical; a frozen-digest mismatch.
- `Trainer.fit` on 2 ranks: the gathered validation against one process
  on the same rows, rank-0 writes, resume; `trainer=ddp_sim` through
  `cli.train.main`; `cli.collect_embeddings.main` on 2 ranks against 1.
- The refusals, and the data loaders' batch counts agreeing across ranks.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from oneprot_tpu.losses import clip_loss as jclip
from oneprot_tpu.losses import clip_loss_masked as jclip_masked
from oneprot_tpu.losses import siglip_loss as jsiglip
from oneprot_tpu.losses import siglip_loss_masked as jsiglip_masked
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.core import mesh as mesh_lib
from oneprot_tpu_torch.data import datamodule as dm_lib
from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.data.synthetic import generate_fixtures
from oneprot_tpu_torch.train.trainer import Trainer
from tests.helpers.torch_dist_child import SLOTS, tiny_module

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# f32 on the CPU: the collectives reorder sums; the module steps add the
# frameworks' last ulps (tests/test_multiprocess.py:138-150's calibration)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5, 1e-7
B, D = 4, 16
N_STEPS, L_ROW, UNPACKED_L = 5, 128, 32
# Adam's update magnifies f32 noise on a near-zero gradient up to lr (see
# tests/test_torch_lora.py): at 1e-4 the frameworks' ulps stay under the bar
LR = 1e-4
RANK_LENGTHS = ((30, 40, 26, 50, 36, 44), (60, 50, 70))  # 6 and 3 pairs


class World:
    """W child processes of one case, started at once; `result()` waits
    (under TIMEOUT, killing them all when it passes) and loads their
    outputs."""

    def __init__(self, root, case: str, world: int, inputs: dict,
                 ext: str = "npz"):
        self.dir = root / f"{case}_{world}"
        self.dir.mkdir()
        np.savez(self.dir / "in.npz", **inputs)
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "WORLD_SIZE", "RANK",
                            "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env["PYTHONPATH"] = ROOT
        self.outs = [self.dir / f"out{r}.{ext}" for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.helpers.torch_dist_child", case,
             str(r), str(world), str(self.dir / "rendezvous"),
             str(self.dir / "in.npz"), str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r, out in enumerate(self.outs)]
        self._results = None

    def result(self) -> list:
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=TIMEOUT)[0].decode())
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            assert all(p.returncode == 0 for p in self.procs), "\n".join(logs)
            self._results = [json.load(open(o)) if str(o).endswith(".json")
                             else dict(np.load(o)) for o in self.outs]
        return self._results


# ---------------------------------------------------------------------------
# inputs


def loss_inputs(world: int) -> dict:
    rng = np.random.RandomState(world)
    n = world * B
    valid = np.zeros(n, np.float32)
    for r in range(world):  # rank r: B - 1 - (r % B) valid slots of B
        valid[r * B:r * B + B - 1 - (r % B)] = 1.0
    return {"mod": rng.randn(n, D).astype(np.float32),
            "seq": rng.randn(n, D).astype(np.float32), "valid": valid,
            "weights": rng.randn(world, n, D).astype(np.float32)}


def _tokens(rng, n, lo, hi):
    t = rng.randint(lo, hi, size=n).astype(np.int32)
    t[0], t[-1] = 0, 2
    return t


def _mirror(rows, token_lists, L):
    """The modality side packed into the slots the sequence side chose."""
    ids = np.full((len(rows), L), 1, np.int32)
    seg = np.full((len(rows), L), -1, np.int32)
    for r, members in enumerate(rows):
        off = 0
        for s, idx in enumerate(members):
            t = token_lists[idx]
            ids[r, off:off + len(t)] = t
            seg[r, off:off + len(t)] = s
            off += len(t)
    return ids, seg


def step_batches() -> dict:
    """N_STEPS global batches: packed (each rank's 2 rows of its own
    proteins, 6 and 3 pairs) and unpacked (B rows a rank)."""
    out = {k: [] for k in ("ids", "seg", "st_ids", "st_seg", "valid",
                           "seq_rows", "st_rows")}
    for i in range(N_STEPS):
        rng = np.random.RandomState(100 + i)
        parts = []
        for lengths in RANK_LENGTHS:
            seqs = [_tokens(rng, n, 4, 24) for n in lengths]
            sts = [_tokens(rng, n, 20, 50) for n in lengths]
            ids, seg, valid, rows = packing.pack_token_rows(seqs, L_ROW, SLOTS)
            assert ids.shape[0] == 2
            parts.append((ids, seg, *_mirror(rows, sts, L_ROW), valid))
        for k, v in zip(("ids", "seg", "st_ids", "st_seg", "valid"),
                        zip(*parts)):
            out[k].append(np.concatenate(v))
        n = len(RANK_LENGTHS) * B
        out["seq_rows"].append(np.stack([_tokens(rng, UNPACKED_L, 4, 24)
                                         for _ in range(n)]))
        out["st_rows"].append(np.stack([_tokens(rng, UNPACKED_L, 20, 50)
                                        for _ in range(n)]))
    return {k: np.stack(v) for k, v in out.items()}


def jax_tiny_module():
    """tests/helpers/tiny_models.py's module (frozen hub, L1 on) at Adam
    LR."""
    from oneprot_tpu.models.encoders import (
        create_sequence_encoder,
        create_struct_token_encoder,
    )
    from oneprot_tpu.train.module import OneProtModule as JaxModule
    from oneprot_tpu.train.optim import adam
    from tests.helpers.tiny_models import patch_tiny_esm2

    patch_tiny_esm2()
    name = "facebook/esm2_t6_8M_UR50D"
    module = JaxModule(
        components={"sequence": create_sequence_encoder(
            model_name_or_path=name, output_dim=32, proj_type="mlp",
            frozen=True, dtype="float32"),
            "struct_token": create_struct_token_encoder(
                model_name_or_path=name, output_dim=32, dtype="float32")},
        optimizer=lambda: adam(LR), use_l1_regularization=True, seed=0,
        frozen_param_dtype=None)
    init_ids = np.full((2, 16), 1, np.int32)
    init_ids[:, 0] = 0
    module.init({"struct_token": (init_ids, init_ids)})
    return module


def save_state(jm, path) -> str:
    torch.save({"configs": {k: dataclasses.asdict(e.config)
                            for k, e in jm.encoders.items()},
                "state": convert.oneprot_state_dict(
                    jax.tree.map(np.asarray, jm.state.params))}, path)
    return str(path)


# ---------------------------------------------------------------------------
# the JAX oracles


def jax_losses(world: int, inp: dict) -> dict:
    """Each loss and its gradients on the global features."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    spec = P("data")

    def sharded(fn, masked=False):
        specs = (spec, spec, spec) if masked else (spec, spec)
        return shard_map(fn, mesh=mesh, in_specs=specs, out_specs=P(),
                         check_vma=False)

    valid = jnp.asarray(inp["valid"])
    fns = {
        "clip_local": sharded(lambda m, s: jclip(m, s, axis_name="data")),
        "clip_global": sharded(lambda m, s: jclip(m, s, axis_name="data",
                                                  local_loss=False)),
        "clip_masked": lambda m, s: jclip_masked(m, s, valid),
        "siglip_bidir": sharded(lambda m, s: jsiglip(m, s, axis_name="data")),
        "siglip_chain": sharded(lambda m, s: jsiglip(m, s, axis_name="data",
                                                     bidir=False)),
        "siglip_masked_bidir": lambda m, s: sharded(
            lambda a, b, v: jsiglip_masked(a, b, v, axis_name="data"),
            True)(m, s, valid),
        "siglip_masked_chain": lambda m, s: sharded(
            lambda a, b, v: jsiglip_masked(a, b, v, axis_name="data",
                                           bidir=False), True)(m, s, valid),
    }
    out = {}
    for name, fn in fns.items():
        loss, (gm, gs) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(
            jnp.asarray(inp["mod"]), jnp.asarray(inp["seq"]))
        out[name] = (float(loss), np.asarray(gm), np.asarray(gs))
    return out


def jax_steps(batches: dict) -> dict:
    """The JAX module's losses and final trainable parameters (port names)
    for each step kind on the global batches."""
    j = jnp.asarray
    out = {}
    for kind in ("packed", "cached", "unpacked"):
        jm = jax_tiny_module()
        state, losses = jm.state, []
        for i in range(N_STEPS):
            if kind == "unpacked":
                state, loss = jm.train_step(state, "struct_token",
                                            batches["seq_rows"][i],
                                            batches["st_rows"][i])
            elif kind == "packed":
                state, loss = jm.train_step_packed(
                    state, "struct_token",
                    {"ids": batches["ids"][i], "segment_ids": batches["seg"][i]},
                    {"ids": batches["st_ids"][i],
                     "segment_ids": batches["st_seg"][i]}, batches["valid"][i])
            else:
                pooled = jm.encode_packed_pooled(
                    state.params, "sequence", j(batches["ids"][i]),
                    j(batches["seg"][i]), SLOTS)
                state, loss = jm.train_step_packed_cached(
                    state, "struct_token", np.asarray(pooled),
                    {"ids": batches["st_ids"][i],
                     "segment_ids": batches["st_seg"][i]}, batches["valid"][i])
            losses.append(float(loss))
        params = convert.oneprot_state_dict(jax.tree.map(np.asarray,
                                                         state.params))
        out[kind] = (np.array(losses), params)
    return out


def port_steps(state: str, batches: dict) -> dict:
    """The port's steps in this process on the global batches: the
    distribution is all the 2-rank run adds."""
    out = {}
    for kind in ("packed", "cached", "unpacked"):
        module, losses = tiny_module(state).init(), []
        for i in range(N_STEPS):
            seq = {"ids": batches["ids"][i], "segment_ids": batches["seg"][i]}
            mod = {"ids": batches["st_ids"][i],
                   "segment_ids": batches["st_seg"][i]}
            if kind == "unpacked":
                loss, _ = module.train_step("struct_token",
                                            batches["seq_rows"][i],
                                            batches["st_rows"][i])
            elif kind == "packed":
                loss, _ = module.train_step_packed("struct_token", seq, mod,
                                                   batches["valid"][i])
            else:
                pooled = module.encode_packed_pooled(
                    "sequence", seq["ids"], seq["segment_ids"], SLOTS)
                loss, _ = module.train_step_packed_cached(
                    "struct_token", pooled, mod, batches["valid"][i])
            losses.append(float(loss))
        out[kind] = (np.array(losses), {
            n: p.detach().numpy() for n, p in module.model.named_parameters()
            if p.requires_grad})
    return out


# ---------------------------------------------------------------------------
# the worlds, started together; the JAX oracles run while they do


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    jm = jax_tiny_module()
    state = save_state(jm, root / "tiny.pt")
    batches = step_batches()
    data = str(root / "fixtures")
    generate_fixtures(data, n_train=16, n_eval=8, modalities=["struct_token"])
    down = root / "downstream"
    down.mkdir()
    seqs = ["MKTAYIAKQRQISFVK", "MVLSPADKTNVKAAWGKV", "MKVLAAGIVG", "MA",
            "MSDNGPQNQRNAPRITFGGPSDSTGS", "MKKLLPTAAAGLLLL", "MQIFV"]
    for split in ("train", "valid", "test"):
        (down / f"ToyCls_{split}.csv").write_text("\n".join(
            ["sequence,label"] + [f"{s},{i % 3}" for i, s in enumerate(seqs)])
            + "\n")
    # batches of one row: a row's embedding is the same in any split
    collect = ["tasks=[ToyCls]", "batch_size=1", f"downstream_dir={down}",
               "max_length=64", "models.esm2.model_name_or_path=esm2_tiny",
               f"paths.log_dir={root / 'clog'}"]
    stale = root / "collect2" / "esm2" / "ToyCls" / "train"
    stale.mkdir(parents=True)
    np.savez(stale / "embeddings_rank2_batch0.npz",
             embeddings=np.zeros((1, 64), np.float32),
             labels_fitness=np.zeros(1, np.int64))
    fit_cfg = {
        "run_dir": str(root / "fit"), "state": state, "dm": dm_kwargs(data),
        "cli": ["experiment=debug_struct_token", "trainer=ddp_sim",
                f"paths.data_dir={data}", f"paths.log_dir={root / 'cli_logs'}",
                "model.components.sequence.model_name_or_path=esm2_tiny",
                "model.components.struct_token.model_name_or_path=esm2_tiny",
                "data.modalities.struct_token.batch_size.train=4",
                "data.modalities.struct_token.batch_size.val=4",
                "data.modalities.struct_token.batch_size.test=4",
                "trainer.limit_train_batches=2",
                "trainer.limit_val_batches=1", "test=true"],
        "cli_logs": str(root / "cli_logs"),
        "collect": collect + [f"output_dir={root / 'collect2'}"]}
    worlds = {
        "losses": {w: World(root, "losses", w, loss_inputs(w))
                   for w in (2, 3, 4)},
        "steps": World(root, "steps", 2, {**batches, "state": np.array(state)}),
        "fit": World(root, "fit", 2, {"cfg": np.array(json.dumps(fit_cfg))},
                     ext="json"),
    }
    oracle = {"losses": {w: jax_losses(w, loss_inputs(w)) for w in (2, 3, 4)},
              "steps": jax_steps(batches), "port": port_steps(state, batches)}
    return {"worlds": worlds, "oracle": oracle, "root": root, "state": state,
            "data": data, "collect": collect, "fit_cfg": fit_cfg}


def dm_kwargs(d, val_batch=4):
    return dict(
        modalities={"struct_token": {
            "dataset": {"data_dir": d, "filename": f"{d}/train_saprot.h5",
                        "max_length": 64},
            "batch_size": {"train": 4, "val": val_batch, "test": val_batch}}},
        buckets=[64], prefetch=0)


# ---------------------------------------------------------------------------
# the collectives and the losses


def test_collectives_values_and_gradients(runs):
    inp = loss_inputs(2)
    r0, r1 = runs["worlds"]["losses"][2].result()
    mod, w = inp["mod"], inp["weights"]
    for rank, r in enumerate((r0, r1)):
        np.testing.assert_array_equal(r["gather/value"], mod)
        # every rank's loss reaches every block: the gradient sums them
        np.testing.assert_allclose(r["gather/grad"],
                                   (w[0] + w[1])[rank * B:(rank + 1) * B],
                                   rtol=1e-6)
        # rank r gets rank r - 1's rows; the gradient goes back the other way
        np.testing.assert_array_equal(r["shift/value"],
                                      mod[(1 - rank) * B:(2 - rank) * B])
        np.testing.assert_array_equal(r["shift/grad"], w[1 - rank][:B])
        np.testing.assert_array_equal(r["gather_rows"],
                                      np.concatenate([mod[:3], mod[:5]]))
        assert float(r["mean"]) == 0.5 and str(r["stamp"]) == "stamp-0"


def _compare_loss(runs, world, name):
    results = runs["worlds"]["losses"][world].result()
    loss, gm, gs = runs["oracle"]["losses"][world][name]
    shares = [float(r[f"{name}/loss"]) for r in results]
    np.testing.assert_allclose(np.mean(shares), loss, rtol=LOSS_RTOL)
    for rank, r in enumerate(results):
        rows = slice(rank * B, (rank + 1) * B)
        for got, want in ((r[f"{name}/grad_mod"], gm), (r[f"{name}/grad_seq"],
                                                        gs)):
            np.testing.assert_allclose(got / world, want[rows],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{name} rank {rank}")
    return shares


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("local", [True, False], ids=["local", "global"])
def test_clip_loss_matches_jax_shard_map(runs, world, local):
    shares = _compare_loss(runs, world,
                           "clip_local" if local else "clip_global")
    if not local:  # every rank holds the whole loss
        assert len(set(shares)) == 1


@pytest.mark.parametrize("world", [2, 3, 4])
def test_clip_masked_ragged_valid_matches_jax_concatenated(runs, world):
    counts = loss_inputs(world)["valid"].reshape(world, B).sum(1)
    assert len(set(counts.tolist())) > 1  # the ranks' valid counts differ
    _compare_loss(runs, world, "clip_masked")


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("bidir", [True, False], ids=["bidir", "chain"])
def test_siglip_ring_matches_jax_shard_map(runs, world, masked, bidir):
    _compare_loss(runs, world, "siglip_" + ("masked_" if masked else "")
                  + ("bidir" if bidir else "chain"))


# ---------------------------------------------------------------------------
# the module's steps


@pytest.mark.parametrize("kind", ["packed", "cached", "unpacked"])
def test_steps_match_jax_on_the_global_batch(runs, kind):
    """Each step's loss against the JAX module's on the global batch at
    1e-5, the final trainable parameters at the port-vs-JAX f32 bar of
    tests/test_torch_train.py (an element whose gradient sits near zero
    takes Adam's magnified noise, in one process too) and, at
    tests/test_multiprocess.py's calibration, against the port's own
    one-process run on the global batch, where only the distribution
    differs."""
    r0, _ = runs["worlds"]["steps"].result()
    losses, params = runs["oracle"]["steps"][kind]
    one_losses, one_params = runs["oracle"]["port"][kind]
    np.testing.assert_allclose(r0[f"{kind}/losses"], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(r0[f"{kind}/losses"], one_losses,
                               rtol=LOSS_RTOL)
    assert len(one_params) > 20
    for name, want in one_params.items():
        got = r0[f"{kind}/param/{name}"]
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got, params[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", ["packed", "cached", "unpacked"])
def test_ranks_hold_bit_identical_parameters(runs, kind):
    r0, r1 = runs["worlds"]["steps"].result()
    keys = [k for k in r0 if k.startswith(f"{kind}/")]
    assert len(keys) > 20
    for key in keys:
        if key != f"{kind}/hits":
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


def test_cache_hit_on_one_rank_miss_on_the_other(runs):
    """Rank 0's cache held the first batch's rows: it hit where rank 1
    missed, and the ranks still met at every collective alike."""
    r0, r1 = runs["worlds"]["steps"].result()
    assert int(r0["cached/hits"]) > int(r1["cached/hits"])
    np.testing.assert_array_equal(r0["cached/losses"], r1["cached/losses"])


def test_frozen_digest_mismatch_raises_on_every_rank(runs):
    for r in runs["worlds"]["steps"].result():
        assert "different frozen weights" in str(r["mismatch"])


# ---------------------------------------------------------------------------
# the trainer, the CLIs


def test_fit_gathered_validation_equals_one_process(runs):
    """The 2-rank run's validation of its final weights (val batches of 4
    a rank) against one process validating `last` in batches of 8 (the
    same global batches): metrics and the gathered features (rank r's rows
    are the val rows r::2)."""
    f0, f1 = runs["worlds"]["fit"].result()
    for key in ("val_seq", "val_mod", "validate", "fit", "params"):
        assert f0[key] == f1[key], key
    module = tiny_module(runs["state"]).init()
    with torch.no_grad():
        for name, p in module.model.named_parameters():
            if p.requires_grad:
                p.copy_(torch.tensor(f0["params"][f"param/{name}"]))
    dm = dm_lib.OneProtDataModule(**dm_kwargs(runs["data"], val_batch=8))
    dm.setup()
    one = Trainer(accelerator="cpu", default_root_dir=str(runs["root"] / "one"))
    want = one.validate(module, dm)
    seqs, mods = [], []
    for seq_in, mod_in, modality, _ in dm.val_dataloader():
        s, m, _ = module.eval_step(modality, seq_in, mod_in)
        seqs.append(s.numpy())
        mods.append(m.numpy())
    order = np.concatenate([np.arange(8)[0::2], np.arange(8)[1::2]])
    np.testing.assert_allclose(np.asarray(f0["val_seq"]),
                               np.concatenate(seqs)[order], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(f0["val_mod"]),
                               np.concatenate(mods)[order], rtol=1e-5,
                               atol=1e-6)
    got = f0["validate"]
    assert sorted(got) == sorted(want) and len(want) > 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_fit_rank0_writes_and_resumes(runs):
    f0, f1 = runs["worlds"]["fit"].result()
    run = runs["fit_cfg"]["run_dir"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    steps = [r["step"] for r in rows if "train/loss" in r]
    # 16 train rows: 8 a rank, 2 batches of 4 an epoch; written once each
    assert steps == sorted(set(steps)) == list(range(1, 7))
    assert f0["fit"]["train/steps"] == 4 and f0["resumed_step"] == 6
    assert f0["resumed"]["train/steps"] == 6
    for name in ("last", "best"):
        assert os.path.isfile(os.path.join(run, "checkpoints", name, "state.pt"))
    with open(os.path.join(run, "checkpoints", "last.metrics.json")) as f:
        assert json.load(f)["trainer/epoch"] == 2.0
    state = torch.load(os.path.join(run, "checkpoints", "last", "state.pt"),
                       weights_only=True)
    assert state["step"] == 6


def test_ddp_sim_through_the_cli_on_two_ranks(runs):
    f0, f1 = runs["worlds"]["fit"].result()
    assert f0["cli"] == f1["cli"] and np.isfinite(list(f0["cli"].values())).all()
    assert f0["cli"]["train/steps"] == 2 and "test/loss" in f0["cli"]
    # one stamp: one run dir, its snapshot written once
    assert f0["cli_runs"] == f1["cli_runs"] and len(f0["cli_runs"]) == 1
    run = os.path.join(runs["fit_cfg"]["cli_logs"], "train", "runs",
                       f0["cli_runs"][0])
    assert os.path.isfile(os.path.join(run, "resolved_config.yaml"))


def test_collect_embeddings_two_ranks_equal_one(runs, tmp_path):
    """Rank r embeds rows r::2 into its own shards; rank 0 combines. The
    combined rows (grouped by rank) are one process's rows, reordered; a
    stale shard of a third rank, left before, is gone."""
    from oneprot_tpu_torch.cli import collect_embeddings as cli

    f0, f1 = runs["worlds"]["fit"].result()
    assert f0["collect"] == f1["collect"] and len(f0["collect"]) == 3
    one = cli.main(runs["collect"] + [f"output_dir={tmp_path / 'one'}"],
                   device="cpu")
    for two_path, one_path in zip(f0["collect"], one):
        two, want = np.load(two_path), np.load(one_path)
        n = len(want["labels_fitness"])
        order = np.concatenate([np.arange(n)[0::2], np.arange(n)[1::2]])
        np.testing.assert_array_equal(two["labels_fitness"],
                                      want["labels_fitness"][order])
        np.testing.assert_allclose(two["embeddings"], want["embeddings"][order],
                                   rtol=1e-5, atol=1e-6)
    shards = sorted(os.listdir(os.path.dirname(f0["collect"][0]) + "/ToyCls/train"))
    assert {s.split("_batch")[0] for s in shards} == {"embeddings_rank0",
                                                      "embeddings_rank1"}


# ---------------------------------------------------------------------------
# refusals and the loaders, in this process


def test_mesh_model_axis_names_its_item():
    """A model axis that does not divide the world (one process here) is
    refused, naming how to launch; the int8 hub over a model axis builds,
    whole on each rank (tests/test_torch_tensor_parallel.py runs the axis
    on gloo worlds)."""
    from oneprot_tpu_torch.models import encoders

    for make in (lambda: Trainer(accelerator="cpu",
                                 mesh={"data": -1, "model": 2}),
                 lambda: mesh_lib.check_mesh({"model": 4})):
        with pytest.raises(ValueError, match="does not divide the world"):
            make()
    with pytest.raises(ValueError, match="mesh.data=2"):
        mesh_lib.check_mesh({"data": 2})
    int8 = encoders.create_sequence_encoder("esm2_tiny", quantize="int8",
                                            device="cpu", dtype="float32",
                                            tp=(2, 0))
    assert not int8.transformer.layers[0].attn.heads_split


def test_devices_beyond_the_world_say_how_to_launch():
    with pytest.raises(ValueError, match="torch.distributed.run "
                                         "--nproc_per_node 2"):
        Trainer(accelerator="cpu", devices=2)
    Trainer(accelerator="cpu", devices=1)  # a world of one


def test_init_distributed_outside_a_launch(monkeypatch):
    """No arguments and no launcher: a no-op; a launcher's world without a
    rank or an address raises; a local rank beyond the host's cards
    raises instead of wrapping around."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "ONEPROT_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    mesh_lib.init_distributed()
    assert not mesh_lib.distributed() and mesh_lib.world() == (1, 0)
    monkeypatch.setenv("ONEPROT_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="nproc_per_node"):
        mesh_lib.init_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="local rank 1 has no card"):
        mesh_lib.init_distributed("localhost:1", num_processes=2,
                                  process_id=1)
    assert not mesh_lib.distributed()


def test_loader_batch_counts_agree_across_ranks(monkeypatch, tmp_path):
    """Unpacked loaders yield the smallest shard's count on every rank
    (17 train rows over 2 ranks: 8 and 9, 2 batches of 4 each; 9 val rows:
    4 and 5, one batch of 4 each), so every rank runs each modality at
    every step."""
    data = str(tmp_path / "fx")
    generate_fixtures(data, n_train=17, n_eval=9, modalities=["struct_token"])
    counts = {}
    for rank in (0, 1):
        monkeypatch.setattr(dm_lib, "data_world", lambda rank=rank: (2, rank))
        dm = dm_lib.OneProtDataModule(**dm_kwargs(data))
        dm.setup()
        train = [b["struct_token"][0].shape[0] for b in dm.train_dataloader()]
        val = [b[0].shape[0] for b in dm.val_dataloader()]
        counts[rank] = (len(dm.train_dataloader()), train, val)
    assert counts[0] == counts[1] == (2, [4, 4], [4])
