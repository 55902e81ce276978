"""OneProtModule: the training and eval steps (counterpart of
oneprot_tpu/train/module.py for `train_step`, `train_step_cached`,
`train_step_fully_cached`, `train_step_packed`, `train_step_packed_cached`,
`eval_step`, `eval_step_cached`, `eval_step_fully_cached`, `encode_pooled`,
`encode_packed_pooled`, CLIP and SigLIP losses, data-parallel over
several processes).

    module = OneProtModule({"sequence": hub, "struct_token": tower},
                           optimizer=lambda: adam(1e-3),
                           use_l1_regularization=True)
    module.init()
    loss, step = module.train_step_packed("struct_token", seq_pack, mod_pack,
                                          valid)

One step is the JAX step's fwd + bwd + update: both towers run packed rows
(several proteins per row, block-diagonal attention), pool per segment, and
the loss (+ 0.01 * masked L1) runs over the per-protein features with
empty pack slots masked; the gradients of the trainable parameters are
clipped by their global norm and Adam steps. A frozen hub without LoRA
runs without an autograd graph. In the cached step the hub's pooled
features come in as an input (from `encode_packed_pooled`) and only its
head runs; a hub that trains (LoRA) is not cacheable and is refused there.
The unpacked step (`train_step`) takes [B, L] padded rows on both sides
(an MSA tower [B, R, L] tokens, a graph tower a dict of padded graph
arrays, each moved to the card in its own dtype) and the plain loss (+
0.01 * mean L1); `train_step_cached` is its twin on
the hub's pooled features (from `encode_pooled`), and
`train_step_fully_cached` takes both towers' pooled features (a frozen hub
and a frozen modality tower, such as the shipped text tower): only the two
heads run. `loss_fn` is "CLIP" (symmetric InfoNCE) or "SigLIP" (pairwise
sigmoid, `losses/siglip.py`) at logit scale 1 with no bias, as the JAX
module calls them: the heads scale the features. Every step runs the
model in training mode with LoRA dropout and the graph towers' noise
and dropout seeded from (seed, step, rank), the counterpart of the JAX
step's fold_in(key(seed), step) (not its numbers; data rank 0's seed is
(seed, step)'s, and the other data ranks draw other masks; the ranks of a
model group draw one mask, as their activations are one replica's). The
eval steps run in eval mode without autograd and return (seq_feats,
mod_feats, loss). The
`scheduler` config is read by the trainer (`train/scheduler.py`). A loss
name other than CLIP or SigLIP raises; the JAX module takes any other
name for SigLIP.

Across several processes (`core/mesh.py:init_distributed`; one process a
card, laid out as the `mesh` config's data x model grid, `check_mesh`)
the module is the JAX module under that mesh on the concatenated batch.
A model group holds one replica between them, each transformer weight
the rules of `core/partitioning.py` split as its shard (the encoders are
built so: `models/encoders.py`), and steps on the same rows; the data
groups split every batch, the same count of rows on every data rank.
`init` broadcasts rank 0's replicated trainable parameters to every rank
and each shard from its model rank of data group 0 over its data group,
and checks that the ranks of each data group hold the same frozen
shards; the training losses take the global batch's negatives over the
data group (CLIP's gather with gradient, by `local_loss`; SigLIP's ring),
each data rank's share scaled so that the gradient all-reduce-mean of
`ClippedOptimizer` gives the global loss's gradient; a packed batch's
masked losses and L1 are normalised by the global valid count. A step
returns the global loss (the mean of the data ranks' shares); an eval
step returns this rank's features and the loss of the global batch,
computed on the features gathered over the data group.
`gather_with_grad` is taken for the config's sake and changes nothing
(the gather always carries the gradient, as in the JAX package).

`load_pretrained` puts a local HF directory's weights into each encoder
that names one (`pretrained_dir`; a shard takes its block), and checks an
int8 hub loaded so against its float twin (the int8 canary). An int8 hub
is held whole on every model rank (`esm2.Esm2`), so each rank runs its
own canary on a whole twin.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from oneprot_tpu_torch.core import collectives, partitioning
from oneprot_tpu_torch.core.mesh import (
    DATA_AXIS,
    check_mesh,
    data_group,
    data_world,
    distributed,
    model_group,
    model_world,
)
from oneprot_tpu_torch.losses.clip import clip_loss, clip_loss_masked
from oneprot_tpu_torch.losses.siglip import siglip_loss, siglip_loss_masked
from oneprot_tpu_torch.models.encoders import OneProtModel
from oneprot_tpu_torch.models.esm2 import Int8Dense, set_lora_dropout_seed
from oneprot_tpu_torch.models.pronet import set_graph_noise_seed
from oneprot_tpu_torch.train import optim as optim_lib
from oneprot_tpu_torch.utils.loggers import get_pylogger

Pack = Mapping[str, Any]  # {"ids": [R, L], "segment_ids": [R, L]}


def _graft(module: torch.nn.Module,
           converted: Mapping[str, torch.Tensor]) -> None:
    """Load `converted`'s full tensors into `module` (each cut to the
    block a shard holds, `partitioning.layout_of`, and cast to its
    parameter's dtype); the module's other leaves keep their values, keys
    the module lacks are ignored, and a shape that differs raises."""
    m, rank = model_world()
    converted = partitioning.shard_state_dict(
        converted, rank, m, partitioning.layout_of(module))
    state = module.state_dict()
    for k, v in converted.items():
        if k in state:
            if tuple(v.shape) != tuple(state[k].shape):
                raise ValueError(f"pretrained shape {tuple(v.shape)} != model "
                                 f"shape {tuple(state[k].shape)} at {k}")
            state[k] = v
    module.load_state_dict(state)


def _full_shape(shape, dim: int, m: int) -> tuple:
    """The shape of the full tensor whose dimension `dim` a shard of
    `shape` holds one of `m` blocks of."""
    full = list(shape)
    full[dim] *= m
    return tuple(full)


class OneProtModule:
    def __init__(
        self,
        components: Dict[str, torch.nn.Module],
        optimizer: Optional[Callable[[], optim_lib.OptimizerFn]] = None,
        scheduler: Optional[Mapping[str, Any]] = None,
        loss_fn: str = "CLIP",
        local_loss: bool = True,
        gather_with_grad: bool = True,
        use_l1_regularization: bool = False,
        use_seqsim: bool = False,
        train_on_all_modalities_after_step: int = 0,
        gradient_clip_val: float = 1.0,
        mesh: Optional[Any] = None,
        seed: int = 0,
        frozen_param_dtype: Optional[str] = "bfloat16",
    ):
        if loss_fn.upper() not in ("CLIP", "SIGLIP"):
            raise ValueError(f"loss_fn={loss_fn!r}: CLIP or SigLIP")
        if mesh is not None:
            check_mesh(mesh)
        if frozen_param_dtype not in (None, "bfloat16", "bf16"):
            raise ValueError(f"frozen_param_dtype={frozen_param_dtype!r}")
        self.loss_name = loss_fn.upper()
        self.encoders = dict(components)
        self.model = OneProtModel(self.encoders)
        self.optimizer_fn = optimizer
        self.scheduler_cfg = scheduler
        # the gather always carries the gradient, as in the JAX package
        del mesh, gather_with_grad
        self.local_loss = local_loss
        self.use_l1_regularization = use_l1_regularization
        self.use_seqsim = use_seqsim
        self.train_on_all_modalities_after_step = int(
            train_on_all_modalities_after_step)
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        self.frozen_param_dtype = frozen_param_dtype
        self.step = 0
        self.opt: Optional[optim_lib.ClippedOptimizer] = None
        self.mask: Optional[Dict[str, bool]] = None
        self.int8_canaries: Dict[str, Optional[Dict[str, float]]] = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init(self) -> "OneProtModule":
        """Mark the trainable parameters (`trainable_mask`), store frozen
        float parameters in bf16 when frozen_param_dtype says so (they
        never meet the optimizer), and build the optimizer over the
        trainable ones. As in the JAX package, the int8 hub's biases go to
        bf16 as well, while its int8 weights and f32 dequantization scales
        keep their dtypes. The weights are the modules' own: load a
        state_dict first. Under a process group every rank then takes rank
        0's replicated trainable parameters and data group 0's shards of
        its model rank, and a rank whose frozen parameters differ from
        those of another rank of its data group (their digest) raises on
        every rank."""
        self.mask = optim_lib.trainable_mask(self.encoders)
        trainable = []
        for name, p in self.model.named_parameters():
            p.requires_grad_(self.mask[name])
            if self.mask[name]:
                trainable.append(p)
            elif self.frozen_param_dtype and p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
        if self.frozen_param_dtype:
            for mod in self.model.modules():
                if isinstance(mod, Int8Dense) and mod.bias is not None:
                    mod.bias = mod.bias.to(torch.bfloat16)
        self.opt = optim_lib.build_optimizer(trainable, self.optimizer_fn,
                                             self.gradient_clip_val)
        self.step = 0
        if distributed():
            self._agree_on_weights(trainable)
        return self

    def _frozen_state(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.model.state_dict().items()
                if not self.mask.get(k, False)}

    def frozen_digest(self) -> str:
        """The frozen state's digest (`feature_cache.params_fingerprint`:
        every entry's name, shape, dtype and first values), the same at
        any model-axis size: model rank 0 digests its shards under their
        full shapes (their first values are the full tensors') and the
        model group takes its digest. An MSA encoder that pools the query
        row alone adds its pooling (`MsaEncoder.cache_tag`), since its
        cached rows are another function of the same weights: a store
        written under one pooling is refused under the other (the JAX
        package's keys ignore the pooling)."""
        from oneprot_tpu_torch.train.feature_cache import params_fingerprint

        m, rank = model_world()
        state = self._frozen_state()
        tags = [f"{name}={enc.cache_tag}" for name, enc in
                sorted(self.encoders.items())
                if getattr(enc, "cache_tag", None)]

        def digest_of(shapes=None) -> str:
            digest = params_fingerprint(state, shapes)
            if tags:
                digest = hashlib.sha256(
                    "|".join([digest, *tags]).encode()).hexdigest()
            return digest

        if m == 1:
            return digest_of()
        layout = partitioning.layout_of(self.model)
        digest = None
        if rank == 0:
            digest = digest_of({k: _full_shape(v.shape, layout[k], m)
                                for k, v in state.items() if k in layout})
        return collectives.broadcast_object(digest, group=model_group())

    def _agree_on_weights(self, trainable) -> None:
        """Rank 0's replicated trainable parameters on every rank, each
        shard from its model rank of data group 0 over its data group; the
        frozen ones must match already within each data group (each rank
        built or loaded them)."""
        from oneprot_tpu_torch.train.feature_cache import params_fingerprint

        sharded = [p.data for p in trainable
                   if getattr(p, "tp_dim", None) is not None]
        collectives.broadcast_([p.data for p in trainable
                                if getattr(p, "tp_dim", None) is None])
        if model_world()[0] > 1:
            collectives.broadcast_(sharded, group=data_group())
        digests = collectives.gather_objects(
            params_fingerprint(self._frozen_state()), group=data_group())
        if len(set(digests)) > 1:
            raise ValueError(
                "the ranks hold different frozen weights (digests "
                f"{digests}): build every rank's model from the same seed "
                "and checkpoint")

    # -- pretrained weights ---------------------------------------------------

    def load_pretrained(self) -> Dict[str, Optional[Dict[str, float]]]:
        """Put converted HF weights into the `transformer` of every encoder
        built from a local checkpoint directory (`pretrained_dir`), as the
        JAX module's `_load_pretrained` does: leaves the checkpoint does
        not cover (LoRA factors) keep their values, each tensor is cast to
        the parameter's dtype, and a shape that differs raises. An int8 hub
        is quantized from the float weights, then checked against its float
        twin by `int8_canary` (unless ONEPROT_INT8_CANARY=0). Returns each
        int8 hub's canary numbers by encoder name, also kept as
        `int8_canaries`."""
        from oneprot_tpu_torch.models import encoders as enc_lib
        from oneprot_tpu_torch.models.esm2 import quantize_esm2_int8_tree
        from oneprot_tpu_torch.models.hf_convert import (
            convert_bert_state_dict,
            convert_esm2_state_dict,
            load_torch_state_dict,
        )

        canaries = {}
        for name, enc in self.encoders.items():
            hf_dir = getattr(enc, "pretrained_dir", None)
            if not hf_dir:
                continue
            sd = load_torch_state_dict(hf_dir)
            float_state = None
            if isinstance(enc, enc_lib.TextEncoder):
                converted = convert_bert_state_dict(sd, enc.config.num_layers)
            elif isinstance(enc, (enc_lib.SequenceEncoder,
                                  enc_lib.StructTokenEncoder)):
                converted = convert_esm2_state_dict(
                    sd, enc.config.num_layers,
                    extra_vocab_rows=max(enc.config.vocab_size - 33, 0),
                    seed=self.seed)
                if enc.quant_int8:
                    float_state = converted
                    converted = quantize_esm2_int8_tree(converted)
            else:
                continue
            _graft(enc.transformer, converted)
            if float_state is not None and os.environ.get(
                    "ONEPROT_INT8_CANARY", "1") != "0":
                canaries[name] = self.int8_canary(name, enc, float_state)
        self.int8_canaries = canaries
        return canaries

    # Swiss-Prot amino-acid frequencies (%) in ESM2 alphabet order for
    # token ids 4..23 (L A G V S E R T I D P K Q N F Y M H W C)
    _ESM2_AA_FREQ = np.array([
        9.66, 8.25, 7.07, 6.87, 6.56, 6.75, 5.53, 5.34, 5.96, 5.45,
        4.70, 5.84, 3.93, 4.06, 3.86, 2.92, 2.42, 2.27, 1.08, 1.38])

    def _canary_probe_ids(self, vocab_size: int) -> np.ndarray:
        """The JAX module's probe: ONEPROT_INT8_CANARY_ROWS (16) rows of
        Swiss-Prot-frequency amino acids from RandomState(0), true lengths
        log-spaced from 32 to ONEPROT_INT8_CANARY_LEN (512), cls/eos
        framed, pad-tailed."""
        rows = max(int(os.environ.get("ONEPROT_INT8_CANARY_ROWS", "16")), 2)
        max_len = max(
            int(os.environ.get("ONEPROT_INT8_CANARY_LEN", "512")), 16)
        probe_rng = np.random.RandomState(0)
        lens = np.round(
            np.geomspace(min(32, max_len), max_len, rows)).astype(int)
        if vocab_size >= 24:
            p = self._ESM2_AA_FREQ / self._ESM2_AA_FREQ.sum()
            aa = probe_rng.choice(np.arange(4, 24, dtype=np.int32),
                                  size=(rows, max_len), p=p)
        else:  # tiny test vocabularies
            aa = probe_rng.randint(4, vocab_size, size=(rows, max_len))
        ids = np.full((rows, max_len), 1, np.int32)  # pad
        for i, li in enumerate(lens):
            ids[i, 0] = 0  # cls
            ids[i, 1:li - 1] = aa[i, 1:li - 1]
            ids[i, li - 1] = 2  # eos
        return ids

    @torch.no_grad()
    def int8_canary(self, name: str, enc,
                    float_state: Mapping[str, torch.Tensor]
                    ) -> Optional[Dict[str, float]]:
        """Compare an int8 hub's pooled embeddings of the probe batch with
        its float twin's (the same config and compute dtype, the float
        weights; bf16 on the card): the centered cosine per row (min and
        mean) and the two-way cross-retrieval R@1, logged as the JAX module
        logs them, with a warning below ONEPROT_INT8_CANARY_MIN (0.98) or
        ONEPROT_INT8_CANARY_R1 (1.0). Returns {"cos_min", "cos_mean", "r1",
        "rows"}, or None (with a warning) when the float weights do not
        cover every leaf of the twin. Unlike the JAX canary, which warns on
        any exception, an error here (a CUDA or kernel error) propagates."""
        from oneprot_tpu_torch.models.esm2 import Esm2

        # an int8 hub is held whole on every model rank (esm2.Esm2), and so
        # is its twin: each rank checks its own copy
        log = get_pylogger("int8_canary")
        threshold = float(os.environ.get("ONEPROT_INT8_CANARY_MIN", "0.98"))
        r1_threshold = float(os.environ.get("ONEPROT_INT8_CANARY_R1", "1.0"))
        device = enc.transformer.embed_tokens.weight.device
        twin = Esm2(enc.config, device=device,
                    dtype=enc.transformer.embed_tokens.compute_dtype).eval()
        missing = set(twin.state_dict()) - set(float_state)
        if missing:
            log.warning(f"int8 canary for '{name}' skipped: float checkpoint "
                        "does not cover every transformer leaf")
            return None
        _graft(twin, float_state)
        ids = torch.from_numpy(self._canary_probe_ids(
            enc.config.vocab_size)).to(device, torch.long)
        mask = ids != enc.config.pad_token_id
        was_training = enc.training
        enc.eval()
        f_q = enc.backbone_pooled(ids).float().cpu().numpy()
        f_b = enc.head.pool(twin(ids), mask).float().cpu().numpy()
        enc.train(was_training)
        del twin
        # centred across the probe's rows: a component all rows share (an
        # outlier channel of the residual stream) would dominate the raw
        # cosine and hide damage in the dimensions retrieval reads
        cq = f_q - f_q.mean(0)
        cb = f_b - f_b.mean(0)
        cos = (cq * cb).sum(-1) / (np.linalg.norm(cq, axis=-1)
                                   * np.linalg.norm(cb, axis=-1) + 1e-12)
        fq = cq / (np.linalg.norm(cq, axis=-1, keepdims=True) + 1e-12)
        fb = cb / (np.linalg.norm(cb, axis=-1, keepdims=True) + 1e-12)
        sim = fq @ fb.T
        n = sim.shape[0]
        r1 = 0.5 * (float((sim.argmax(1) == np.arange(n)).mean())
                    + float((sim.argmax(0) == np.arange(n)).mean()))
        msg = (f"int8 canary '{name}': bf16-vs-int8 pooled-embedding "
               f"centered cosine min={cos.min():.4f} "
               f"mean={cos.mean():.4f} (threshold {threshold}), "
               f"cross-retrieval R@1={r1:.4f} over {n} rows "
               f"(threshold {r1_threshold})")
        if cos.min() < threshold or r1 < r1_threshold:
            log.warning(
                msg + " — int8 quantization degrades this checkpoint's "
                "embeddings; re-run with model.components."
                f"{name}.quantize=null and compare retrieval quality")
        else:
            log.info(msg)
        return {"cos_min": float(cos.min()), "cos_mean": float(cos.mean()),
                "r1": r1, "rows": n}

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        """A numpy array or tensor on the model's device."""
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _inputs(self, x):
        """A modality's input on the model's device: token ids [B, L] (or
        an MSA's [B, R, L]) as int64, a graph dict array by array in its
        own dtype."""
        if isinstance(x, Mapping):
            return {k: self._tensor(v) for k, v in x.items()}
        return self._tensor(x, torch.long)

    def _axis(self) -> Optional[str]:
        """The data axis under a process group, else None."""
        return DATA_AXIS if distributed() else None

    def _loss_value(self, mod_feats: torch.Tensor, seq_feats: torch.Tensor,
                    axis_name: Optional[str] = None) -> torch.Tensor:
        """CLIP or SigLIP over the batch, + 0.01 * the mean L1 of both
        sides' features; with `axis_name`, this rank's share (its rows
        against the global batch, the same row count on every rank)."""
        if self.loss_name == "CLIP":
            loss = clip_loss(mod_feats, seq_feats, axis_name=axis_name,
                             local_loss=self.local_loss)
        else:
            loss = siglip_loss(mod_feats, seq_feats, axis_name=axis_name)
        if self.use_l1_regularization:
            loss = loss + 0.01 * (seq_feats.float().abs().mean()
                                  + mod_feats.float().abs().mean())
        return loss

    def _packed_loss_value(self, mod_feats: torch.Tensor,
                           seq_feats: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
        """CLIP or SigLIP over the packed batch's slots, + 0.01 * the masked
        L1 of both sides' features (mean over the real pairs' elements of
        every rank's pack); across processes, this rank's share."""
        axis = self._axis()
        loss = (clip_loss_masked if self.loss_name == "CLIP"
                else siglip_loss_masked)(mod_feats, seq_feats, valid,
                                         axis_name=axis)
        if self.use_l1_regularization:
            v = valid.float()[:, None]
            count = collectives.sum_across(v.sum()) if axis else v.sum()
            n = count.clamp_min(1.0) * seq_feats.shape[-1] / data_world()[0]
            loss = loss + 0.01 * (
                (seq_feats.float().abs() * v).sum() / n
                + (mod_feats.float().abs() * v).sum() / n)
        return loss

    def _eval_loss(self, mod_feats: torch.Tensor,
                   seq_feats: torch.Tensor) -> torch.Tensor:
        """The loss of the global batch: every rank's features gathered
        (their row counts may differ), then the loss of one process."""
        return self._loss_value(collectives.gather_rows(mod_feats),
                                collectives.gather_rows(seq_feats))

    def _begin_step(self) -> None:
        """Training mode, and this step's seed for LoRA dropout and for the
        graph towers' noise and dropout: (seed, step), with the data rank
        in the high bits, so that data ranks draw different masks and the
        ranks of a model group, whose activations are one replica's, the
        same one."""
        self.model.train()
        seed = self.seed * 1_000_003 + self.step + (data_world()[1] << 40)
        set_lora_dropout_seed(self.model, seed)
        set_graph_noise_seed(self.model, seed)

    def _update(self, loss: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """Backward, the optimizer's step; returns the global loss (the
        mean of the ranks' shares) and the step count."""
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.step += 1
        return collectives.mean_across(loss.detach()), self.step

    def train_step(self, modality: str, seq_ids,
                   mod_ids) -> Tuple[torch.Tensor, int]:
        """One optimizer step over UNPACKED rows: seq_ids, mod_ids [B, L]
        padded token ids (numpy or tensors; a graph tower's mod_ids is a
        dict of padded graph arrays), pair i in row i of each. Returns
        (loss as a device scalar, step count)."""
        self._begin_step()
        seq_feats = self.model(self._inputs(seq_ids), "sequence")
        mod_feats = self.model(self._inputs(mod_ids), modality)
        return self._update(self._loss_value(mod_feats, seq_feats,
                                              self._axis()))

    def train_step_cached(self, modality: str, seq_pooled,
                          mod_ids) -> Tuple[torch.Tensor, int]:
        """`train_step` with the hub's pooled features cached: seq_pooled
        [B, d_model] (from `encode_pooled`); only the hub's head and the
        modality tower run. Refused for a hub that is not cacheable."""
        self._require_cacheable_hub()
        self._begin_step()
        seq_feats = self.model.head_from_pooled(self._tensor(seq_pooled),
                                                "sequence")
        mod_feats = self.model(self._inputs(mod_ids), modality)
        return self._update(self._loss_value(mod_feats, seq_feats,
                                              self._axis()))

    def train_step_fully_cached(self, modality: str, seq_pooled,
                                mod_pooled) -> Tuple[torch.Tensor, int]:
        """`train_step` with BOTH towers' pooled features cached (a frozen
        hub and a frozen modality tower: seq<->text, seq<->msa, seqsim):
        seq_pooled, mod_pooled [B, d_model] from `encode_pooled`; only the
        two heads run."""
        self._begin_step()
        seq_feats, mod_feats = self._heads(modality, seq_pooled, mod_pooled)
        return self._update(self._loss_value(mod_feats, seq_feats,
                                              self._axis()))

    def _heads(self, modality: str, seq_pooled, mod_pooled
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(seq_feats, mod_feats) of both heads on pooled features."""
        return (self.model.head_from_pooled(self._tensor(seq_pooled),
                                            "sequence"),
                self.model.head_from_pooled(self._tensor(mod_pooled),
                                            modality))

    def hub_is_cacheable(self) -> bool:
        """Whether the hub's pooled features stay the same for all training
        (frozen, no LoRA): only then may the cached step stand in for it."""
        enc = self.encoders.get("sequence")
        return bool(getattr(enc, "backbone_is_cacheable", False))

    def modality_is_cacheable(self, modality: str) -> bool:
        """Whether the MODALITY tower's pooled features are constant
        (seqsim routes to the hub)."""
        if modality in ("sequence", "seqsim"):
            return self.hub_is_cacheable()
        enc = self.encoders.get(modality)
        return bool(getattr(enc, "backbone_is_cacheable", False))

    def _require_cacheable_hub(self) -> None:
        if not self.hub_is_cacheable():
            raise ValueError("the hub trains (LoRA) or is not frozen: its "
                             "pooled features cannot be cached")

    def train_step_packed(self, modality: str, seq_pack: Pack, mod_pack: Pack,
                          valid) -> Tuple[torch.Tensor, int]:
        """One optimizer step over PACKED rows of both sides. seq_pack,
        mod_pack: {"ids": [R, L], "segment_ids": [R, L]} (numpy or
        tensors), the same proteins in the same slots; valid [R, P].
        Returns (loss as a device scalar, step count)."""
        self._begin_step()
        valid = self._tensor(valid, torch.float32)
        P = valid.shape[1]
        seq_feats, _ = self.model.encode_packed(
            self._tensor(seq_pack["ids"], torch.long),
            self._tensor(seq_pack["segment_ids"], torch.int32), P, "sequence")
        mod_feats, _ = self.model.encode_packed(
            self._tensor(mod_pack["ids"], torch.long),
            self._tensor(mod_pack["segment_ids"], torch.int32), P, modality)
        return self._update(
            self._packed_loss_value(mod_feats, seq_feats, valid.reshape(-1)))

    def train_step_packed_cached(self, modality: str, seq_pooled,
                                 mod_pack: Pack, valid
                                 ) -> Tuple[torch.Tensor, int]:
        """The packed step with the hub's pooled features cached:
        seq_pooled [R*P, d_model] slot-aligned (from
        `encode_packed_pooled`); only the hub's head and the modality tower
        run. Refused for a hub that is not cacheable."""
        self._require_cacheable_hub()
        self._begin_step()
        valid = self._tensor(valid, torch.float32)
        P = valid.shape[1]
        seq_feats = self.model.head_from_pooled(self._tensor(seq_pooled),
                                                "sequence")
        mod_feats, _ = self.model.encode_packed(
            self._tensor(mod_pack["ids"], torch.long),
            self._tensor(mod_pack["segment_ids"], torch.int32), P, modality)
        return self._update(
            self._packed_loss_value(mod_feats, seq_feats, valid.reshape(-1)))

    @torch.no_grad()
    def encode_packed_pooled(self, modality: str, ids, segment_ids,
                             num_segments: int) -> torch.Tensor:
        """Frozen backbone over PACKED rows -> per-protein pooled
        [R*P, d_model]: the cached step's input."""
        pooled, _ = self.model.encode_packed_pooled(
            self._tensor(ids, torch.long),
            self._tensor(segment_ids, torch.int32), num_segments, modality)
        return pooled

    @torch.no_grad()
    def encode_pooled(self, modality: str, ids) -> torch.Tensor:
        """Frozen backbone over padded rows [B, L] -> pooled [B, d_model]:
        the cached step's input."""
        return self.model.encode_pooled(self._inputs(ids), modality)

    @torch.no_grad()
    def eval_step(self, modality: str, seq_ids, mod_ids
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Both towers over padded rows in eval mode: (seq_feats,
        mod_feats, loss)."""
        self.model.eval()
        seq_feats = self.model(self._inputs(seq_ids), "sequence")
        mod_feats = self.model(self._inputs(mod_ids), modality)
        return seq_feats, mod_feats, self._eval_loss(mod_feats, seq_feats)

    @torch.no_grad()
    def eval_step_cached(self, modality: str, seq_pooled, mod_ids
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """`eval_step` on the hub's pooled features."""
        self.model.eval()
        seq_feats = self.model.head_from_pooled(self._tensor(seq_pooled),
                                                "sequence")
        mod_feats = self.model(self._inputs(mod_ids), modality)
        return seq_feats, mod_feats, self._eval_loss(mod_feats, seq_feats)

    @torch.no_grad()
    def eval_step_fully_cached(self, modality: str, seq_pooled, mod_pooled
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
        """`eval_step` on both towers' pooled features."""
        self.model.eval()
        seq_feats, mod_feats = self._heads(modality, seq_pooled, mod_pooled)
        return seq_feats, mod_feats, self._eval_loss(mod_feats, seq_feats)

    def modalities_to_train(self, step: int, batch_keys) -> list:
        """Curriculum gate: struct_token alone before
        train_on_all_modalities_after_step, then every modality of the
        batch (seqsim only with use_seqsim)."""
        if step < self.train_on_all_modalities_after_step:
            return [m for m in ("struct_token",) if m in batch_keys]
        mods = list(batch_keys)
        if not self.use_seqsim and "seqsim" in mods:
            mods.remove("seqsim")
        return mods

    def num_params(self) -> Tuple[int, int]:
        """(total, trainable) parameter counts."""
        total = sum(p.numel() for p in self.model.parameters())
        trainable = sum(p.numel() for p in self.model.parameters()
                        if p.requires_grad)
        return total, trainable
