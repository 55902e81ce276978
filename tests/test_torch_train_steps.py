"""Several packed training steps of the port against the JAX package, on the
CPU at the ESM2-35M struct-token tower's full width.

The tower is `esm2_t12_35M` as bench.py trains it (12 layers, hidden 480,
20 heads of 24, 21 3Di rows, linear head to 1024, logit scale 1/0.07); the
frozen hub is the patched tiny `esm2_t6_8M` of tests/helpers/tiny_models.py
with its mlp head to 1024, so the run stays small. Four packed rows of 256
tokens, 4 slots a row, Adam at bench.py's 1e-3 after clipping at 1.0: eight
`train_step_packed` steps on one batch in each framework, from the same
weights (JAX init, carried over by oneprot_tpu_torch.convert). Random
weights make the loss climb above its start for a few steps at this rate;
the port must climb and fall with the JAX step, step for step.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_train_steps.py -q -s

prints both trajectories.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.models import encoders, esm2
from oneprot_tpu_torch.train import optim
from oneprot_tpu_torch.train.module import OneProtModule
from tests.helpers.tiny_models import patch_tiny_esm2
from tests.test_torch_train import _mirror, _numpy_tree, _tokens

ROWS, ROW_LEN, SLOTS, STEPS, LR = 4, 256, 4, 8, 1e-3
# f32 on the CPU: the frameworks differ in summation order and the last ulp
# of erf, exp and LayerNorm; eight Adam steps carry those differences on
# (measured: at most 4.3e-6 relative), the f32 bar of the one-step tests
# still holds
RTOL = 1e-4


def _jax_module():
    patch_tiny_esm2()
    from oneprot_tpu.models.encoders import (
        create_sequence_encoder,
        create_struct_token_encoder,
    )
    from oneprot_tpu.train.module import OneProtModule as JaxOneProtModule
    from oneprot_tpu.train.optim import adam

    hub = create_sequence_encoder(
        model_name_or_path="facebook/esm2_t6_8M_UR50D", output_dim=1024,
        proj_type="mlp", frozen=True, dtype="float32")
    tower = create_struct_token_encoder(dtype="float32")  # esm2_t12_35M
    module = JaxOneProtModule(
        components={"sequence": hub, "struct_token": tower},
        optimizer=lambda: adam(LR), loss_fn="CLIP",
        use_l1_regularization=True, mesh=None, seed=0,
        frozen_param_dtype=None)
    init_ids = np.full((2, 16), 1, np.int32)
    init_ids[:, 0] = 0
    module.init({"struct_token": (init_ids, init_ids)})
    return module


def _port_module(jax_module):
    jenc = jax_module.encoders
    cfg = lambda name: esm2.Esm2Config(**dataclasses.asdict(jenc[name].config))
    hub = encoders.SequenceEncoder(cfg("sequence"), 1024, proj_type="mlp",
                                   frozen=True, device="cpu",
                                   dtype=torch.float32)
    tower = encoders.StructTokenEncoder(cfg("struct_token"), 1024,
                                        device="cpu", dtype=torch.float32)
    module = OneProtModule({"sequence": hub, "struct_token": tower},
                           optimizer=optim.adam(LR),
                           use_l1_regularization=True,
                           frozen_param_dtype=None)
    module.model.load_state_dict(
        convert.oneprot_state_dict(_numpy_tree(jax_module.state.params)))
    return module.init()


def _batch(seed=0):
    """Log-normal lengths around 60 residues, clipped to [20, ROW_LEN],
    packed while they fit in ROWS rows of SLOTS slots."""
    rng = np.random.RandomState(seed)
    lengths, misses = [], 0
    while misses < 20:
        n = int(np.clip(rng.lognormal(np.log(60.0), 0.5), 20, ROW_LEN))
        if len(packing.pack_lengths(lengths + [n], ROW_LEN, SLOTS)) > ROWS:
            misses += 1
            continue
        lengths.append(n)
        misses = 0
    seqs = [_tokens(rng, n) for n in lengths]
    sts = [_tokens(rng, n, lo=20, hi=53) for n in lengths]
    ids, seg, valid, rows = packing.pack_token_rows(seqs, ROW_LEN, SLOTS)
    st_ids, st_seg = _mirror(rows, sts, ROW_LEN)
    return ids, seg, st_ids, st_seg, valid


def test_packed_steps_track_jax_at_tower_width():
    jm = _jax_module()
    pm = _port_module(jm)
    assert pm.model.encoders["struct_token"].config.hidden_size == 480
    ids, seg, st_ids, st_seg, valid = _batch()
    assert ids.shape == (ROWS, ROW_LEN)
    j = jnp.asarray
    step = jax.jit(jm.train_step_packed_fn("struct_token", SLOTS))
    state, jax_losses = jm.state, []
    for _ in range(STEPS):
        state, loss = step(state, j(ids), j(seg), j(st_ids), j(st_seg),
                           j(valid.reshape(-1)))
        jax_losses.append(float(loss))
    losses = [pm.train_step_packed(
        "struct_token", {"ids": ids, "segment_ids": seg},
        {"ids": st_ids, "segment_ids": st_seg}, valid)[0].item()
        for _ in range(STEPS)]
    print(f"\n{int(valid.sum())} proteins, Adam {LR:g}\n"
          f"JAX  losses: {', '.join(f'{x:.6f}' for x in jax_losses)}\n"
          f"port losses: {', '.join(f'{x:.6f}' for x in losses)}")
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jax_losses, rtol=RTOL)
