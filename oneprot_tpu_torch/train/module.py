"""OneProtModule: the training steps (counterpart of
oneprot_tpu/train/module.py for `train_step`, `train_step_packed` and
`train_step_packed_cached`, CLIP loss, one process).

    module = OneProtModule({"sequence": hub, "struct_token": tower},
                           optimizer=adam(1e-3), use_l1_regularization=True)
    module.init()
    loss, step = module.train_step_packed("struct_token", seq_pack, mod_pack,
                                          valid)

One step is the JAX step's fwd + bwd + update: both towers run packed rows
(several proteins per row, block-diagonal attention), pool per segment, and
the CLIP loss (+ 0.01 * masked L1) runs over the per-protein features with
empty pack slots masked; the gradients of the trainable parameters are
clipped by their global norm and Adam steps. A frozen hub without LoRA
runs without an autograd graph. In the cached step the hub's pooled
features come in as an input (from `encode_packed_pooled`) and only its
head runs; a hub that trains (LoRA) is not cacheable and is refused there.
The unpacked step (`train_step`) takes [B, L] padded rows on both sides
and the plain CLIP (+ 0.01 * mean L1). Every step runs the model in
training mode with LoRA dropout seeded from (seed, step), the counterpart
of the JAX step's fold_in(key(seed), step).

Not ported here: SigLIP, sharding over several cards, the int8 canary,
the fully cached step, schedulers.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from oneprot_tpu_torch.losses.clip import clip_loss, clip_loss_masked
from oneprot_tpu_torch.models.encoders import OneProtModel
from oneprot_tpu_torch.models.esm2 import Int8Dense, set_lora_dropout_seed
from oneprot_tpu_torch.train import optim as optim_lib

Pack = Mapping[str, Any]  # {"ids": [R, L], "segment_ids": [R, L]}


class OneProtModule:
    def __init__(
        self,
        components: Dict[str, torch.nn.Module],
        optimizer: Optional[optim_lib.OptimizerFn] = None,
        loss_fn: str = "CLIP",
        use_l1_regularization: bool = False,
        gradient_clip_val: float = 1.0,
        mesh: Optional[Any] = None,
        seed: int = 0,
        frozen_param_dtype: Optional[str] = "bfloat16",
    ):
        if loss_fn.upper() != "CLIP":
            raise NotImplementedError(f"loss_fn={loss_fn!r}: only CLIP is ported")
        if mesh is not None:
            raise NotImplementedError("sharding over a mesh is not ported")
        if frozen_param_dtype not in (None, "bfloat16", "bf16"):
            raise ValueError(f"frozen_param_dtype={frozen_param_dtype!r}")
        self.encoders = dict(components)
        self.model = OneProtModel(self.encoders)
        self.optimizer_fn = optimizer
        self.use_l1_regularization = use_l1_regularization
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        self.frozen_param_dtype = frozen_param_dtype
        self.step = 0
        self.opt: Optional[optim_lib.ClippedOptimizer] = None
        self.mask: Optional[Dict[str, bool]] = None

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
        state_dict first."""
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
        return self

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        """A numpy array or tensor on the model's device."""
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _loss_value(self, mod_feats: torch.Tensor,
                    seq_feats: torch.Tensor) -> torch.Tensor:
        """CLIP over the batch, + 0.01 * the mean L1 of both sides'
        features."""
        loss = clip_loss(mod_feats, seq_feats)
        if self.use_l1_regularization:
            loss = loss + 0.01 * (seq_feats.float().abs().mean()
                                  + mod_feats.float().abs().mean())
        return loss

    def _packed_loss_value(self, mod_feats: torch.Tensor,
                           seq_feats: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
        """CLIP over the packed batch's slots, + 0.01 * the masked L1 of
        both sides' features (mean over the real pairs' elements)."""
        loss = clip_loss_masked(mod_feats, seq_feats, valid)
        if self.use_l1_regularization:
            v = valid.float()[:, None]
            n = v.sum().clamp_min(1.0) * seq_feats.shape[-1]
            loss = loss + 0.01 * (
                (seq_feats.float().abs() * v).sum() / n
                + (mod_feats.float().abs() * v).sum() / n)
        return loss

    def _begin_step(self) -> None:
        """Training mode, and this step's LoRA dropout seed."""
        self.model.train()
        set_lora_dropout_seed(self.model, self.seed * 1_000_003 + self.step)

    def _update(self, loss: torch.Tensor) -> Tuple[torch.Tensor, int]:
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.step += 1
        return loss.detach(), self.step

    def train_step(self, modality: str, seq_ids,
                   mod_ids) -> Tuple[torch.Tensor, int]:
        """One optimizer step over UNPACKED rows: seq_ids, mod_ids [B, L]
        padded token ids (numpy or tensors), pair i in row i of each.
        Returns (loss as a device scalar, step count)."""
        self._begin_step()
        seq_feats = self.model(self._tensor(seq_ids, torch.long), "sequence")
        mod_feats = self.model(self._tensor(mod_ids, torch.long), modality)
        return self._update(self._loss_value(mod_feats, seq_feats))

    def hub_is_cacheable(self) -> bool:
        """Whether the hub's pooled features stay the same for all training
        (frozen, no LoRA): only then may the cached step stand in for it."""
        enc = self.encoders.get("sequence")
        return bool(getattr(enc, "backbone_is_cacheable", False))

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
        if not self.hub_is_cacheable():
            raise ValueError("the hub trains (LoRA) or is not frozen: its "
                             "pooled features cannot be cached")
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
