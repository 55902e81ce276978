#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (oneprot_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout; imports torch, numpy, the
standard library and oneprot_tpu_torch only. Phases, each announced with
the elapsed seconds:

1. device: card name, power limit, torch and CUDA versions;
2. build: every CUDA kernel of the serving and training paths, from the
   checkout's sources, one nvcc call per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it (the flash-MHA forward and backward at the
   35M tower's and the hub's packed shapes, at the tower's unpacked shape
   and on the struct-token segment ids of a real packed batch, the
   backward's dq kernel with its prologue (q_r and delta) and its dk/dv
   kernel each against its own plain version too, each case timed beside
   SDPA's backward with the share of tiles the kernels visit and the bound
   over the logit pairs the inputs need, and the forward timed at each case
   beside SDPA's forward with the share of its query-block x key-tile pairs
   it visits and its needed-work and dense bounds; the tied-row attention at
   embed_msas's depth 16 and the MSA data config's depth 50 at 1024 and 512
   columns, off the tile grid and on a batch padded to its bucket; the
   GELU->int8 kernel at the 650M hub's fc1 width and the 15B width's; the
   FlashAttention-2 forward at the ESM2-15B width's B=32 H=40 L=1024
   D=128, at D=64 and 256, at L=300 and on heads of 24 padded by
   dot_product_attention, its dq kernel (with the backward's prologue:
   q_s and delta) and dk/dv kernel at the LoRA step's B=16 H=40 L=1024
   D=128, at D=64 and 256 and at L=300), with its time, the plain
   version's, a library call's where one computes the same function, and
   the card's lower bound; the whole FA-2 backward on the card (dq, then
   dk/dv) is timed beside scaled_dot_product_attention's backward; and
   the flash-MHA kernels without rotary tables, as BERT calls them (heads
   of 64, 12 heads): the forward at embed_texts' B=32 L=512 with rows
   padded 0-75%, the forward and both backward kernels at the LoRA text
   step's B=16 L=512 and on the text rows of a packed batch (key bias and
   segment ids), each call launching its kernel exactly once; the f32
   instances of #1-#3 (the debug towers' float32) at the debug hub's
   packed rows (B=16 L=1024 H=20 D=16, 16 segments a row), at
   bert_tiny's heads of 64 (key bias, no rotary), on ragged packed rows
   (L=200, tails of padding tiles) and on the segment ids of
   train_packed's real packed batch, one launch each, against their
   f32 plain versions (max rel err <= 1e-4, lse within 1e-5), timed
   beside SDPA in f32 and their f32 bound (#2 + #3 beside SDPA's f32
   backward), and the tiled #1-#3 built without spills at every head
   dim 8-64 (-Xptxas -v); #8 on heads
   of 16 (the debug MSA tower's, zero-padded to 64 around the launch)
   at the bf16 gate; and #5, #6 and #7 with segment ids on
   train_packed's real packed batch at the ESM2-15B width's heads (B=16
   H=40 L=1024 D=128), each against its plain version on the same ids
   (padded rows finite), timed beside it, SDPA with the dense mask, the
   share of tiles it visits and its needed-work and dense bounds, and #5
   at D=256 with ids (its mma.sync instance masks, visits every tile);
4. serving: the full-width ESM2-650M hub (random weights from a seed) with
   the 1024-wide mlp head answers 3 requests of 32 sequences and one top-10
   retrieval, bf16 hub then int8 hub, each built by `create_sequence_encoder`
   with its defaults (bf16, on the card); the launch counters, set to 0
   before each hub and read after it, show its kernels ran;
5. parity: the same weights at 2 layers on the card (bf16, kernels) against
   the CPU (f32, plain versions);
6. serving at the ESM2-15B width: `create_sequence_encoder` on the
   committed HF config.json of esm2_t48_15B_UR50D (48 layers of 5120, 40
   heads of 128, FFN 20480; random weights from a seed, bf16, 30 GB on
   the card) with the mlp head answers 3 requests of 32 sequences (their
   own numpy seed) and one top-10 retrieval; every attention runs through
   the FlashAttention-2 kernel, none through flash-MHA; then the same
   weights at 2 layers, card (bf16, kernels) against CPU (f32, plain), as
   they are and quantized to the int8 hub (its 20480-wide fc1 rows through
   the GELU->int8 kernel), and the hub is freed;
7. serving MSA-1b: the full-width esm_msa1b tower (12 x 768, random weights
   from a seed) with its mlp head, built by `create_msa_encoder` with its
   defaults, answers 3 requests of 4 synthetic .a3m MSAs (64 homologs
   each, with gaps and insertions) through `embed_msas`'s defaults (depth
   16, batch 4, up to 1024 columns) and one top-10 retrieval; every row
   attention runs through the tied-row kernel;
8. MSA parity: the same weights at 2 layers, card (bf16, kernel) against
   CPU (f32, plain version), on the tower's output token by token and on
   the embeddings; then the same weights with `use_all_msa=False` (the
   query row pooled, mean) answer the first request through #8 (12
   launches a batch) and match the CPU at 2 layers (mean cosine >=
   0.999);
9. training: bench.py's model at full width (frozen ESM2-650M hub with its
   mlp head, trainable ESM2-35M struct-token tower, CLIP + 0.01 L1, clipped
   Adam at SMOKE_LR), built by `create_sequence_encoder`,
   `create_struct_token_encoder` and `OneProtModule`, takes 6
   `train_step_packed` steps on one packed batch (16 rows of 1024 tokens,
   16 slots), then 6
   `train_step_packed_cached` steps on the hub's pooled features; the
   counters, set to 0 before each path, show every attention ran through
   the kernels (and no plain version ran), and the loss falls;
10. training parity: the same weights at 2 hub + 2 tower layers, one packed
   step on the card (bf16, kernels) against the CPU (f32, plain versions),
   and cached == uncached on the card;
11. trainer: `Trainer.fit` over `OneProtDataModule` (train_packed.yaml's
   packing: 16 rows of 1024 tokens, 16 slots; the default buckets; val
   batches of 16) on 512 train and 128 val synthetic seq <-> 3Di pairs
   (bench.py's log-normal lengths, their own numpy seed) held in memory by
   a subclass of the package's `StructTokenDataset`; the same model as 9,
   fresh random weights, Adam at bench.py's 1e-3, the plateau scheduler:
   2 epochs through the frozen-feature cache (epoch 1: a packed hub
   forward per batch, then `train_step_packed_cached`; epoch 2 and its
   validation served from the cache), each ending in a validation
   (val/loss, R@1/10/100, median ranks), a checkpoint and the scheduler,
   then a second `Trainer(max_epochs=3)` resumes from `checkpoints/last`
   for one more epoch. It prints pairs/s and the median batch wall per
   epoch (beside the bare cached step of 9), the validation walls, each
   checkpoint's save time and size, the cache's hit rates and the peak
   memory; the launch counters, read per epoch and per validation, must
   be exact (33 #1 launches a hub forward, 12 each of #1, #2, #3 a tower
   step, 12 #1 a validation batch), no plain version may run, every loss
   must be finite, the resume must continue the step and the epoch, and
   the plateau scheduler, driven with patience 0 on a metric that does
   not improve, must halve the learning rate once;
12. trainer parity: the trainer (packed + cache) at 2 hub + 2 tower layers
   of the same initial weights, 4 steps (2 epochs of 2 batches of 2 rows,
   the second epoch from the cache) at Adam 1e-3, and again at 1e-4,
   card (bf16, kernels) against CPU (f32, plain versions): each step's
   loss within 2e-2 relative, the final trainable parameters' cosine >=
   0.99; both margins under the gate are printed;
13. LoRA training at the ESM2-15B width: `create_sequence_encoder` on the
   committed config.json with LoRA (r 16, alpha 16, dropout 0.1 on q, k,
   v), frozen bf16 weights and per-layer remat, the mlp head, the
   trainable ESM2-35M struct-token tower, CLIP + 0.01 L1 and clipped Adam
   at SMOKE_LR, takes 2 unpacked `train_step`s, each on a fresh batch of
   16 pairs bucketed to at most 1024 tokens, then 3 `train_step_packed`s
   on fresh batches at train_packed.yaml's packing (16 rows of 1024
   tokens, 16 slots: the hub's heads of 128 through #5-#7 with segment
   ids); the counters show the exact launches per step of either kind
   (the FlashAttention-2 forward twice a hub layer, forward and remat
   recompute; its dq and dk/dv kernels once a hub layer; flash-MHA once a
   tower layer each way; no plain version), another unpacked step is
   split into forward, backward and clip + Adam by CUDA events, and one
   more, on the same batch, is profiled (torch.profiler: device time by
   kernel group); the hub's LoRA factors go through
   `hf_convert.export_peft_lora` (peft's layout) and back through
   `import_peft_lora` bit for bit;
14. LoRA training parity: the same initial weights at 2 hub + 2 tower
   layers, LoRA dropout 0, two unpacked steps on the card (bf16, kernels)
   against the CPU (f32, plain versions); the second step starts both
   from the CPU's weights after the first (see `lora_parity`); then the
   same on 2 packed rows of 256 tokens (#5-#7 with segment ids on the
   card, the JAX layer's dense mask on the CPU);
15. cli: `oneprot_tpu_torch.cli.train.main`, in process, on the checkout's
   configs/: `experiment=train_packed` with
   `data=struct_token_only` and bench.py's widths in bf16 (`CLI_MODEL`),
   on 11's synthetic pairs served from memory through an alias of the
   configs' data-module target (`CliDataModule`), 2 epochs through the
   cache and the test split, then `train=false test=true ckpt_path=<last>`.
   Gated: the launches of each epoch, validation and test batch, 100% hits
   in epoch 2, finite val and test metrics, the run dir's snapshot,
   metrics and checkpoints, no yaml, h5py, jax or oneprot_tpu module
   loaded, and the test-only run's metrics against a restore of `last`
   (rel 1e-5). It prints compose ms, model build s, fit s, pairs/s per
   epoch, test s and checkpoint s beside the card's name and power limit;
   then `OneProtEmbedder.from_run_dir(<run>).embed_struct_tokens` answers
   one request of 32 3Di strings (12 #1 launches, nothing else);
16. text serving: `embed_texts` on `create_text_encoder`'s defaults
   (BiomedBERT-base: 12 x 768, 12 heads of 64, the mlp head with the
   fixed logit scale, bf16, random weights from a seed), 3 requests of
   32 texts of tiny-vocabulary words (log-normal token counts around 150,
   at most 512) and one top-10 retrieval: finite embeddings of norm
   1/0.07, each text finds itself first, 12 #1 launches a request and no
   plain version; then 2 layers of the same weights card vs CPU (least
   cosine >= 0.999);
17. text cli: `experiment=seq_text` through `cli.train.main` with the
   ESM2-650M hub and BiomedBERT-base (names, resolved to sizes; bf16;
   weights from the config's seed) on 512 / 128 / 128 synthetic pairs
   from memory (`MemoryTexts` through the data-module alias): CLIP 2
   epochs and the test split (the frozen text tower: the fully cached
   steps; epoch 2's validation hits in full and launches nothing, and
   epoch 2's training runs a backbone again only for a batch whose padded
   rows went to another bucket, since the cache keys padded rows), a LoRA
   text tower with SigLIP for 1 epoch (`train_step_cached`: BERT through
   #1-#3), and that on packed rows for TEXT_PACKED_BATCHES batches
   (`train_step_packed_cached`). Gated: the launches of every epoch,
   validation and test as the batch and backbone-forward counts predict,
   finite losses and
   metrics, no plain version, no yaml/h5py/jax/pandas module loaded;
18. text parity: 2 hub + 2 BERT layers of full width, LoRA text, SigLIP,
   2 `train_step_cached` steps at Adam 1e-3, card (bf16, kernels) vs CPU
   (f32, plain): loss within 2e-2 a step, trainable parameters' cosine
   >= 0.99;
19. graph tower: `create_struct_graph_encoder` at struct_graph.yaml's
   widths (ProNet hidden 128, 4 layers, out 1024, f32; random weights from
   a seed) on 3 requests of 16 synthetic backbones of 1024 residues,
   written as PDB text, parsed by `structure_io` and built by
   `protein_to_padded_graph` (K=24) inside `embed_structures`, then at
   pocket.yaml's on 128 residues: graphs/s end to end and for the tower
   alone, peak memory, no counter moved; card vs CPU in eval mode on the
   same weights, least cosine >= 0.999;
20. seq<->msa and seqsim: `Trainer.fit` over `OneProtDataModule` with
   msa.yaml's and seqsim.yaml's datasets (depth 50; synthetic .a3m files
   of log-normal length around 290 columns, 64 homologs; seqsim files with
   one benign and one pathogenic mutation a protein), one bucket of 1024,
   the frozen ESM2-650M hub and esm_msa1b, both cached
   (`train_step_fully_cached`, use_seqsim), 2 epochs: epoch 1 fills both
   caches (33 #1 a hub forward, 12 #8 an MSA forward, exact); epoch 2 and
   its validation launch neither (100% hits); pairs/s per epoch and
   modality, the batch wall split, the cache's host bytes;
21. pretrained hub: the ESM2-650M hub written as a local HF checkpoint
   (config.json and a 2.6 GB f32 model.safetensors of seeded weights, HF
   names, by `write_safetensors` here), read back by the port's reader
   (timed, GB/s), then `experiment=train_packed` with the hub's
   `model_name_or_path` set to the directory and `quantize=int8` through
   `cli.train.build_model`: the loaded leaves equal the file's (after the
   bf16 cast; the int8 codes and scales equal its quantization), the int8
   canary returns finite numbers (printed, not gated: random weights)
   with exactly 66 #1 and 33 #4 launches, and one request of 32 runs on
   the loaded int8 hub;
22. the shipped default configs/train.yaml through `cli.train.main` (data
   oneprot: pocket, seqsim, struct_graph, text; model oneprot: the
   ESM2-650M hub, ProNet struct_graph and pocket, BiomedBERT-base text;
   only paths, accelerator, epochs and the data module's alias
   overridden): 2 epochs and the test split on synthetic data (the HDF5
   modalities from memory through `CliDataModule`, text and seqsim files
   on disk); pairs/s per modality and epoch, the batch wall split, exact
   launches (33 #1 a hub forward, 12 a BERT forward, nothing else), no
   plain version; then, on its run dir: `cli.eval.main` over a combined
   CSV of 128 rows (structures served from memory): 6 pairs x 2
   directions, all finite, the fixed-width CSV layout, #1 exactly (33 +
   12) x 8 batches and nothing else, the sequence and text embeddings
   equal to `from_run_dir`'s; again from a reference Lightning `.ckpt` of
   the sequence and text towers (reference names) with those embeddings
   identical; and `cli.collect_embeddings.main` with the hub checkpoint
   of 21 as `esm2` and the run as `oneprot` on ToyCls splits of 64: rows,
   labels, #1 33 a batch of either model, the `esm2` embeddings equal to
   the hub's masked mean computed here; then the downstream probes
   (`probe_phase`): `cli.saprot_fit_mlp.main` in config form on those
   `esm2` files and in flag form on the `oneprot` ones (the results CSVs'
   columns, finite values), then `fit_mlp_probe` at saprot_mlp.yaml's
   defaults on 16384 / 2048 / 2048 rows of 1280 from a numpy seed with a
   planted low-rank teacher each, for EC (585, multi-label), GO-BP (1943),
   DeepLoc10 and ThermoStability: on the card, each task's test metric at
   or above chance + a quarter of the teacher's gap over chance, card vs
   CPU at dropout 0 for 3 epochs of 2048 train rows (val_loss rel 1e-4,
   test-logit cosine >= 0.99999, the same epochs), f1_max against a
   float64 recomputation
   on the card, no kernel, no plain version and no sklearn, xgboost, lmdb
   or wandb loaded; epochs, steps/s, rows/s, epoch, validation and test
   ms, f1_max's host ms and the peak printed; `cli.saprot_fit_cls.main`
   last (an ImportError naming xgboost and scikit-learn on the card's
   host);
23. the f32 experiments as shipped: `experiment=debug_struct_token`,
   `experiment=train_packed` (`data=struct_token_only`, 1 epoch) and
   `experiment=debug_all_modalities` through `cli.train.main`, each to
   its end (train and test), with the f32 instances of #1-#3 launched and
   no bf16 flash-MHA; debug_all_modalities' MSA tower through #8 on heads
   of 16;
24. data-parallel (a): the CLI phase's run (train_packed, bf16, full
   width, 2 epochs) again in three child processes at once, two alone and
   one with `trainer=ddp` in torchrun's environment (a world of one over
   NCCL: `init_distributed`, the gather, the gradient all-reduce, rank-0
   checkpoints), all under torch's deterministic algorithms (the tower's
   embedding backward adds with atomics otherwise; the kernels are
   deterministic either way); the two single runs show whether the run is
   reproducible bit for bit, and the NCCL run's logged losses and val
   metrics must equal the first single run's bit for bit, or, where the
   single runs differ, lie within their spread key by key (printed); the
   in-process run of the CLI phase is compared too (printed);
25. data-parallel (b): two ranks over gloo on the one card (NCCL refuses
   a card twice), each building the full-width model (650M hub, 35M
   tower) from the seed and taking its half (8 rows) of two packed
   batches of 16 rows of 1024 tokens: 4 `train_step_packed`, 4
   `train_step_packed_cached` and 2 cached SigLIP steps (the ring, W=2);
   this process runs the same steps on the whole rows (its SigLIP the
   ring's function: each half normalised by its own valid slots). Each
   step's loss within rel 1e-2 (the margin printed), the change of the
   trainable parameters over the steps (final minus seeded) with cosine
   >= GLOO_DELTA_COS against this process's change, the final parameters
   bit-identical across the ranks, #1-#3 exactly as many times on each
   rank as the steps need and no plain version. A control must fail the
   change gate: each rank runs the steps again from the seed with the
   CLIP gather's backward cut to its own loss (`local_only_gather`). The
   step ms per rank and the gradient all-reduce's ms are printed with the
   card's name and power limit.
26. tensor parallel (A): `experiment=train_3b_tp trainer=gpu
   trainer.mesh.model=2` through `cli.train.main` in four children of this
   script, gloo ranks on the one card laid out data 2 x model 2: the
   ESM2-3B hub at full width and depth (36 x 2560, 20 of its 40 heads a
   rank), BiomedBERT-base (6 of 12 heads a rank) and the ProNet towers
   (whole), random weights from the config's seed with biases drawn too
   (`draw_biases`), on synthetic pocket, struct_graph, text and seqsim
   data; cut to 4 packed rows of 512 a process, graph batches of 4, 2
   batches, no validation or test, the graph towers' noise and dropout
   off. This process then replays both data ranks' recorded batches,
   merged, at mesh.model 1. Gated: each step's loss within TP_LOSS_REL,
   the trainable parameters' change at cosine >= TP_DELTA_COS against
   this process's while a control run with the row-parallel bias added on
   every model rank falls below it, the ranks' trainable parameters and
   losses bit-identical and their seeded weights this process's, #1
   launched on every rank as often as here, each forward on half the
   heads, no plain version, a rank's hub bytes <= TP_HUB_BYTES of this
   process's; the step ms and the row-parallel all-reduces' ms printed;
   then each rank runs the recipe again with the int8 hub
   (`model.components.sequence.quantize=int8`, one batch), held whole
   on every model rank as the JAX rules place its int8 leaves: its
   pooled features on a fixed batch must equal this process's whole int8
   hub's on the same seeded weights bit for bit, #4 launched on every
   rank; the ranks' resident hub bytes are printed beside one process's;
27. tensor parallel (B): `experiment=train_packed data=struct_token_only
   trainer.mesh.model=2` at the CLI phase's widths on two gloo ranks (data
   1 x model 2): the trainable 35M tower split, #1-#3 on 10 of its 20
   heads; 4 packed rows of 1024, 3 batches and a validation batch; the
   same gates against the CLI at mesh.model 1 in this process, the control
   dropping `copy_to_model_group`'s backward all-reduce, and the
   checkpoint the ranks wrote restored at model 1 equal to the file and
   to the ranks' joined parameters bit for bit. Its ranks run without
   torch's deterministic algorithms, as a CLI run does by default: the
   replicas' bit-identity is then the model group's gradient sync's
   doing; each step's largest difference between the two ranks' own
   gradients of the replicated parameters, before the sync, is printed.

Every check raises on failure, so the exit code is non-zero. The last line
is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from oneprot_tpu_torch.cli import collect_embeddings as cli_collect
from oneprot_tpu_torch.cli import default_config_dir
from oneprot_tpu_torch.cli import eval as cli_eval
from oneprot_tpu_torch.cli import train as cli_train
from oneprot_tpu_torch.core.collectives import (
    all_gather_with_grad,
    all_reduce_mean_,
)
from oneprot_tpu_torch.core.mesh import (
    init_distributed,
    shutdown_distributed,
    world,
)
from oneprot_tpu_torch.core.config import (
    TARGET_ALIASES,
    load_config,
    prepare_run_dir,
    register_target_alias,
)
from oneprot_tpu_torch.data import graphs, packing, structure_io, synthetic
from oneprot_tpu_torch.data.common import pick_bucket
from oneprot_tpu_torch.data.datamodule import OneProtDataModule
from oneprot_tpu_torch.data.datasets.struct_graph_dataset import StructDataset
from oneprot_tpu_torch.data.datasets.struct_token_dataset import (
    StructTokenDataset,
)
from oneprot_tpu_torch.data.datasets.text_dataset import TextDataset
from oneprot_tpu_torch.data.tokenizers import (
    TINY_WORDS,
    esm2_tokenizer,
    resolve_text_tokenizer,
)
from oneprot_tpu_torch.kernels import _build, flash_mha, gelu_quant
from oneprot_tpu_torch.kernels import flash_attention as fa
from oneprot_tpu_torch.kernels import tied_row_attention as tra
from oneprot_tpu_torch.losses import clip as clip_lib
from oneprot_tpu_torch.losses import siglip as siglip_lib
from oneprot_tpu_torch.models import bert, esm2, msa_transformer
from oneprot_tpu_torch.models.encoders import (
    OneProtModel,
    SequenceEncoder,
    StructTokenEncoder,
    TextEncoder,
    create_msa_encoder,
    create_sequence_encoder,
    create_struct_graph_encoder,
    create_struct_token_encoder,
    create_text_encoder,
)
from oneprot_tpu_torch.evaluation import retrieval_eval
from oneprot_tpu_torch.serving import DEFAULT_BUCKETS, OneProtEmbedder
from oneprot_tpu_torch.train import checkpoint as checkpoint_lib
from oneprot_tpu_torch.train import module as module_lib
from oneprot_tpu_torch.train.feature_cache import FrozenFeatureCache
from oneprot_tpu_torch.train.module import OneProtModule
from oneprot_tpu_torch.train.optim import adam
from oneprot_tpu_torch.train.scheduler import (
    ReduceLROnPlateau,
    get_learning_rate,
)
from oneprot_tpu_torch.train.trainer import Trainer

T0 = time.time()

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# flop/s, f32 flop/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
FLASH_REL_TOL = 1.5e-2     # max |kernel - plain| / max |plain|, bf16
# the f32 instances of #1-#3: max rel err against the f32 plain versions,
# and the lse's max abs err on the real rows
F32_REL_TOL, F32_LSE_TOL = 1e-4, 1e-5
# exp2 a second on the card's special-function units (the FA-3 paper's
# figure for the H100 SXM: 3.9 TFLOP/s of exponentials)
SFU_EXP2_S = 3.9e12
SCALE_REL_TOL = 1e-5       # GELU->int8 row scales
CODE_FLIP_SHARE = 1e-3     # GELU->int8 codes off by one, at most this share
N_LAYERS = 33
# ESM2 at its largest published size, widths from its HF config.json
WIDE_HUB = esm2.HUB_CONFIG_DIR / "esm2_t48_15B_UR50D"
WIDE_LAYERS = 48
TOWER_LAYERS = 12
AAS = "ACDEFGHIKLMNPQRSTVWY"
BUCKETS = (256, 384, 512, 768, 1024)
# the packed step of configs/experiment/train_packed.yaml: 16 rows of 1024
# tokens (bench.py's 16384-token budget), 16 slots a row
ROWS, ROW_LEN, SLOTS = 16, 1024, 16
PACKED_SEG_SEED = 3  # the kernels phase's packed batch (segment ids only)
STEPS = 6
PARITY_ROWS = 4
# the 15B-width parities (serving and the LoRA step) on 2 rows: their CPU
# halves compute 5120-wide f32 layers
WIDE_PARITY_ROWS = 2
# MSA serving: 3 requests of 4 MSAs, 64 homologs of one query each, through
# embed_msas's defaults (depth 16, batch 4, up to 1024 columns)
MSA_REQUESTS, MSAS_PER_REQUEST, HOMOLOGS = 3, 4, 64
MSA_LAYERS, MSA_DEPTH = 12, 16
# MSA parity: the least cosine of any unpadded token of the 2-layer tower's
# output, card (bf16) against CPU (f32)
MSA_TOKEN_COS = 0.999
# Adam's rate here: at bench.py's 1e-3 the loss of random weights on one
# repeated batch rises above its start within a few steps, in the JAX
# package's step as in the port's (tests/test_torch_train_steps.py holds the
# two step for step at the tower's full width; scripts/profile_torch_train.py
# shows it at full width on the card); at 1e-4 it falls step after step. The
# rate changes no work done in a step.
SMOKE_LR = 1e-4
# the LoRA-15B step: 16 pairs a step, LoRA as configs/model/components/
# sequence.yaml sets it (use_lora: r 16, alpha 16, dropout 0.1 on q/k/v);
# unpacked steps (2 since the packed ones also run #5-#7), then packed
# steps at train_packed.yaml's packing (ROWS x ROW_LEN, SLOTS slots)
LORA_BATCH, LORA_STEPS, LORA_PACKED_STEPS = 16, 2, 3
# the packed LoRA parity's batch: 2 rows of 256 tokens, 4 slots a row
# (its CPU half computes 5120-wide f32 layers)
LORA_PARITY_ROW_LEN, LORA_PARITY_SLOTS = 256, 4
LORA = dict(use_lora=True, lora_r=16, lora_alpha=16, lora_dropout=0.1)
# the trainer phase: synthetic seq <-> 3Di pairs (their own numpy seed) at
# configs/data/default.yaml's buckets, a val batch of 16, Adam at bench.py's
# 1e-3 (no loss-falls gate there), a loss read every 10 steps
TRAINER_PAIRS, TRAINER_VAL_PAIRS, TRAINER_VAL_BATCH = 512, 128, 16
TRAINER_SEED, TRAINER_LR, TRAINER_LOG_EVERY = 11, 1e-3, 10
DATA_BUCKETS = (128, 256, 384, 512, 768, 1024)
FOLDSEEK = "pynwrqhgdlvtmfsaeikc"  # the 3Di letters
# the trainer parity: 8 pairs in 2 batches of 2 packed rows, 2 epochs
PARITY_TRAIN_PAIRS, TRAINER_PARITY_ROWS, TRAINER_PARITY_STEPS = 8, 2, 4
# the CLI phase: configs/experiment/train_packed.yaml at bench.py:1212-1224's
# widths in bf16 (the shipped struct_token_debug model is ESM2-8M in f32,
# which Esm2 refuses on the card: its attention kernels take bf16 only);
# `data=struct_token_only`, as
# the experiment keeps train.yaml's five-modality data group
CLI_BASE = ("experiment=train_packed", "trainer=gpu", "data=struct_token_only",
            "extras.print_config=false")
CLI_MODEL = (
    "model.components.sequence.model_name_or_path=facebook/esm2_t33_650M_UR50D",
    "model.components.sequence.output_dim=1024",
    "model.components.sequence.proj_type=mlp",
    "model.components.sequence.frozen=true",
    "model.components.sequence.dtype=bfloat16",
    "model.components.struct_token.model_name_or_path="
    "facebook/esm2_t12_35M_UR50D",
    "model.components.struct_token.dtype=bfloat16",
    "model.use_l1_regularization=true")
CLI_TEST_BATCH = 64  # configs/data/modalities/struct_token.yaml's test batch
# the data-parallel phases: each world's children under one time limit;
# phase (b)'s batches, weights and steps, and its gates
DDP_TIMEOUT_S = 420
GLOO_SEED, GLOO_HUB_SEED, GLOO_TOWER_SEED = 19, 23, 29
GLOO_WORLD, GLOO_PACKED, GLOO_CACHED, GLOO_SIGLIP = 2, 4, 4, 2
# (the change cosine's limit lies between the clean runs' readings and the
# local-only-gather control's, both in PERF.md)
GLOO_LOSS_REL, GLOO_DELTA_COS = 1e-2, 0.999
CLI_DATA_TARGET = "oneprot_tpu.data.datamodule.OneProtDataModule"
# the text path: BiomedBERT-base (12 x 768, 12 heads of 64), bf16, random
# weights from TEXT_SEED; texts of one-token words of the tiny WordPiece
# vocabulary with log-normal token counts around 150, at most 512
TEXT_MODEL = "microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract-fulltext"
TEXT_LAYERS, TEXT_HEADS, TEXT_L = 12, 12, 512
TEXT_SEED, TEXT_REQUESTS = 13, 3
TEXT_MEDIAN_TOKENS, TEXT_SIGMA, TEXT_MAX_TOKENS = 150.0, 0.6, 512
TEXT_WORDS = ([w for w in TINY_WORDS if not w.startswith("##")]
              + [chr(c) for c in range(ord("a"), ord("z") + 1)]
              + [str(d) for d in range(10)])
TEXT_COS = 0.999  # text tower at 2 layers, card vs CPU, least cosine
# configs/experiment/seq_text.yaml at configs/model/oneprot.yaml's widths:
# the ESM2-650M hub and BiomedBERT-base (names, resolved to sizes)
TEXT_CLI_BASE = (
    "experiment=seq_text", "trainer=gpu", "extras.print_config=false",
    "model.components.sequence.model_name_or_path=facebook/esm2_t33_650M_UR50D",
    f"model.components.text.model_name_or_path={TEXT_MODEL}")
TEXT_LORA_SIGLIP = ("model.components.text.use_lora=true",
                    "model.loss_fn=SigLIP")
TEXT_VAL_BATCH, TEXT_TEST_BATCH = 16, 64  # configs/data/modalities/text.yaml
TEXT_PACKED_BATCHES, TEXT_PACKED_VAL = 4, 2
TEXT_PARITY_STEPS, TEXT_PARITY_BATCH = 2, 8


def phase(name: str) -> None:
    print(f"[{time.time() - T0:7.1f} s] {name}", flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def sample_seqs(n: int, rng) -> list:
    """Log-normal lengths around 290 residues, clipped to [20, 1022]."""
    lens = np.clip(rng.lognormal(np.log(290.0), 0.75, n), 20, 1022).astype(int)
    return ["".join(rng.choice(list(AAS), n_res)) for n_res in lens]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over `iters` launches after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


LAUNCHERS = {"flash_mha_fwd": flash_mha.flash_mha_cuda,
             "flash_mha_bwd_dq": flash_mha.flash_mha_bwd_dq_cuda,
             "flash_mha_bwd_dkv": flash_mha.flash_mha_bwd_dkv_cuda,
             "flash_mha_fwd_f32": flash_mha.flash_mha_f32_cuda,
             "flash_mha_bwd_dq_f32": flash_mha.flash_mha_bwd_dq_f32_cuda,
             "flash_mha_bwd_dkv_f32": flash_mha.flash_mha_bwd_dkv_f32_cuda,
             "gelu_quant": gelu_quant.gelu_quant_cuda,
             "tied_row_attention": tra.tied_row_attention_cuda,
             "flash_attention_fwd": fa.flash_attention_fwd_cuda,
             "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_cuda,
             "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_cuda}
# the plain versions, counted by the wrappers `count_plain_calls` installs
PLAINS = ((flash_mha, "mha_attention_plain"),
          (flash_mha, "mha_attention_bwd_plain"),
          (flash_mha, "flash_mha_bwd_dq_plain"),
          (flash_mha, "flash_mha_bwd_dkv_plain"),
          (gelu_quant, "gelu_quant_reference"),
          (tra, "tied_row_attention_plain"),
          (fa, "flash_attention_plain"),
          (fa, "flash_attention_bwd_plain"),
          (fa, "flash_attention_bwd_dq_plain"),
          (fa, "flash_attention_bwd_dkv_plain"))
PLAIN_CALLS = {name: 0 for _, name in PLAINS}


def count_plain_calls() -> None:
    """Count every call of a plain version from here on, so a run can show
    that none stood in for a kernel on the card."""
    for mod, name in PLAINS:
        def counted(*args, _fn=getattr(mod, name), _name=name, **kw):
            PLAIN_CALLS[_name] += 1
            return _fn(*args, **kw)

        setattr(mod, name, counted)


def reset_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
    for name in PLAIN_CALLS:
        PLAIN_CALLS[name] = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def entry_name(mangled: str) -> str:
    """The unqualified name of a kernel from its (Itanium-mangled) symbol:
    "fwd_tiled" from "_ZN6f32mha9fwd_tiledILi16EEEv..."; an extern "C"
    kernel's symbol as it is."""
    m = re.match(r"_ZN?", mangled)
    if m is None:
        return mangled
    name, i = mangled, m.end()
    while (n := re.match(r"\d+", mangled[i:])) is not None:
        i += n.end()
        name, i = mangled[i:i + int(n.group())], i + int(n.group())
    return name


def ptxas_report(log: str) -> list:
    """(kernel and template arguments, registers and spills) of each kernel
    instance in nvcc's -Xptxas=-v output, e.g. ("fwd_kernel<128,64>",
    "Used 168 registers, ...; 0 bytes spill stores, 0 bytes spill loads"),
    and ("note", line) for each of ptxas's C75xx performance notes (wgmma
    serialised, ...)."""
    out, instance, spills = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            symbol = re.search(r"'([^']+)'", line)
            instance = (entry_name(symbol.group(1)) if symbol else "") + "<" + ",".join(
                re.findall(r"L[ib](\d+)E", line)) + ">"
            spills = ""
        elif re.search(r"\(C75\d\d\)", line):
            out.append(("note", line.strip()))
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((instance, line.split(":", 1)[-1].strip() + "; " + spills))
    return out


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_inputs(B, L, H, D, gen, segments=False, n_seg=4):
    dev = "cuda"
    q, k, v = (torch.randn(B, L, H * D, device=dev, generator=gen,
                           dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(L // 2, L + 1, (B,), device=dev, generator=gen)
    valid = torch.arange(L, device=dev)[None, :] < lens[:, None]
    bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
    cos, sin = esm2.rotary_cos_sin(L, D, device=dev)
    seg = None
    if segments:  # n_seg contiguous proteins per row, padding as its own id
        seg = (torch.arange(L, device=dev)[None, :] * n_seg // L).repeat(B, 1)
        seg = torch.where(valid, seg, -1).to(torch.int32)
    return q, k, v, bias, cos, sin, seg, valid


def check_flash(gen) -> dict:
    H, D = 20, 64
    worst_rel, worst_abs, worst_lse = 0.0, 0.0, 0.0
    cases = [(8, 64, False), (8, 512, False), (8, 1024, False), (8, 512, True),
             (32, 1024, False)]
    for B, L, segmented in cases:
        q, k, v, bias, cos, sin, seg, valid = attention_inputs(B, L, H, D, gen,
                                                               segmented)
        out, lse = flash_mha.mha_attention(q, k, v, H, bias=bias, rope_cos=cos,
                                           rope_sin=sin, segment_ids=seg)
        ref, ref_lse = flash_mha.mha_attention_plain(
            q, k, v, H, bias=bias, rope_cos=cos, rope_sin=sin, segment_ids=seg)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-6)
        # lse on real rows only: a padded row of a packed batch sees only
        # keys at -1e9, where f32 keeps no digits of the logits
        lse_err = (lse - ref_lse).abs()[valid[:, None, :].expand_as(lse)].max().item()
        require(torch.isfinite(out.float()).all().item(), f"flash L={L}: non-finite")
        print(f"  flash-MHA B={B} L={L} H={H} D={D} segments={segmented}: "
              f"max rel err {rel:.3e}, max abs err {diff:.3e}, "
              f"lse max abs err {lse_err:.3e}", flush=True)
        require(rel <= FLASH_REL_TOL, f"flash L={L}: rel err {rel} > {FLASH_REL_TOL}")
        require(lse_err <= 5e-2, f"flash L={L}: lse err {lse_err}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
        worst_lse = max(worst_lse, lse_err)

    # timed at the serving path's largest shape: a batch of 32 at bucket 1024
    B, L = cases[-1][:2]
    q, k, v, bias, cos, sin, _, _ = attention_inputs(B, L, H, D, gen)
    kernel = time_ms(lambda: flash_mha.mha_attention(
        q, k, v, H, bias=bias, rope_cos=cos, rope_sin=sin))
    plain = time_ms(lambda: flash_mha.mha_attention_plain(
        q, k, v, H, bias=bias, rope_cos=cos, rope_sin=sin), iters=5)
    heads = lambda x: x.view(B, L, H, D).transpose(1, 2)
    qr = flash_mha.apply_rotary(heads(q).float(), cos, sin).to(torch.bfloat16)
    kr = flash_mha.apply_rotary(heads(k).float(), cos, sin).to(torch.bfloat16)
    vh, mask = heads(v).contiguous(), bias.to(torch.bfloat16)
    library = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vh, attn_mask=mask))
    nbytes = 4 * B * L * H * D * 2 + B * L * 4 + B * H * L * 4 + 2 * L * D * 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * B * H * L * L * D, BF16_FLOPS)
    print(f"  flash-MHA timed at B={B} L={L}: kernel {kernel:.4f} ms, plain "
          f"{plain:.4f} ms, SDPA {library:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    return {"name": "flash_mha_fwd", "route": "cuda",
            "source": "oneprot_tpu_torch/kernels/csrc/flash_mha_fwd.cu",
            "replaces": "oneprot_tpu/kernels/flash_mha.py:157",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "lse_max_abs_err": worst_lse, "ms": kernel, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library,
            "shape": f"B={B} L={L} H={H} D={D} bf16", "cases": [],
            "note": "cases: the forward timed at each flash-MHA backward "
                    "case (packed shapes: tiles visited, needed-work and "
                    "dense bounds, SDPA's forward with the dense mask)"}


def check_gelu_quant(gen) -> dict:
    """The GELU->int8 kernel against its plain version at the 650M hub's
    int8 MLP shape (a batch of 32 x 512 tokens, fc1 width 5120) and at the
    ESM2-15B width's (20480: rows read once); each timed beside the plain
    version and its byte bound. The first is the row, the second a case."""
    cases = []
    for M, N in ((32 * 512, 5120), (32 * 512, 20480)):
        y = (torch.randn(M, N, device="cuda", generator=gen) * 2.0).to(torch.bfloat16)
        q, s = gelu_quant.fused_gelu_quant(y)
        q_ref, s_ref = gelu_quant.gelu_quant_reference(y)
        torch.cuda.synchronize()
        code_diff = (q.int() - q_ref.int()).abs()
        max_diff = code_diff.max().item()
        flips = code_diff.ne(0).float().mean().item()
        scale_rel = ((s - s_ref).abs() / s_ref).max().item()
        deq_err = (q.float() * s - q_ref.float() * s_ref).abs().max().item()
        print(f"  gelu->int8 M={M} N={N}: max code diff {max_diff}, "
              f"share off by one {flips:.2e}, scale max rel err {scale_rel:.2e}, "
              f"dequantized max abs err {deq_err:.3e}", flush=True)
        require(max_diff <= 1, f"gelu->int8 N={N}: codes differ by > 1")
        require(flips <= CODE_FLIP_SHARE, f"gelu->int8 N={N}: {flips} of codes flipped")
        require(scale_rel <= SCALE_REL_TOL, f"gelu->int8 N={N}: scale rel err {scale_rel}")
        del q, s, q_ref, s_ref, code_diff
        kernel = time_ms(lambda: gelu_quant.fused_gelu_quant(y))
        plain = time_ms(lambda: gelu_quant.gelu_quant_reference(y), iters=5)
        b_ms, b_by = bound_ms(M * N * 2 + M * N + M * 4, 10.0 * M * N, F32_FLOPS)
        print(f"  gelu->int8 timed at M={M} N={N}: kernel {kernel:.4f} ms, plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        cases.append({"shape": f"M={M} N={N} bf16", "max_abs_err": deq_err,
                      "max_code_diff": max_diff,
                      "code_flip_share": flips, "ms": kernel, "plain_ms": plain,
                      "bound_ms": b_ms, "bound_by": b_by})
        del y
        torch.cuda.empty_cache()
    row, wide = cases
    return {"name": "gelu_quant", "route": "cuda",
            "source": "oneprot_tpu_torch/kernels/csrc/gelu_quant.cu",
            "replaces": "oneprot_tpu/kernels/gelu_quant.py:60",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_code_diff": max(c["max_code_diff"] for c in cases),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "shape": row["shape"],
            "cases": [wide]}


def check_tied_row(gen) -> dict:
    """The tied-row kernel against its plain version at embed_msas's shape
    (B=4 R=16 L=1024 H=12) and at the MSA data config's depth (R=50), at
    the buckets 1024 and 512, off the tile grid (L=300, 3 heads, the last
    17 columns masked) and on a batch padded as embed_msas pads one (four
    MSAs of 1000, 302, 517 and 190 columns in the bucket 1024: the kernel
    skips the key tiles of padding). All but L=300 are timed beside
    scaled_dot_product_attention over the same function (heads of R*64 in
    [B, H, L, R*64], with the scale and the column mask) and the bound (on
    the padded batch, over the keys that carry weight). The first case is
    the row, the others its cases."""
    worst_rel, worst_abs, cases = 0.0, 0.0, []
    padded = (1000, 302, 517, 190)
    for B, R, L, nh, valid in ((4, MSA_DEPTH, 1024, 12, None), (4, 50, 1024, 12, None),
                               (4, MSA_DEPTH, 512, 12, None), (4, 50, 512, 12, None),
                               (4, MSA_DEPTH, 300, 3, (283,) * 4),
                               (4, MSA_DEPTH, 1024, 12, padded)):
        q, k, v = (torch.randn(B, R, L, nh * 64, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        lens = valid or (L,) * B
        bias = torch.zeros(B, 1, 1, L, device="cuda")
        for b, n in enumerate(lens):
            bias[b, ..., n:] = -1e9
        out = tra.tied_row_attention_cuda(q, k, v, nh, col_bias=bias)
        ref = tra.tied_row_attention_plain(q, k, v, nh, col_bias=bias)
        torch.cuda.synchronize()
        require(torch.isfinite(out.float()).all().item(),
                f"tied-row R={R} L={L}: non-finite")
        diff = (out.float() - ref.float()).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-6)
        shape = (f"B={B} R={R} L={L} H={nh} D=64 bf16"
                 + (f", columns {'/'.join(map(str, lens))}" if valid else ""))
        print(f"  tied-row {shape}: max rel err {rel:.3e}, max abs err {diff:.3e}",
              flush=True)
        require(rel <= FLASH_REL_TOL,
                f"tied-row {shape}: rel err {rel} > {FLASH_REL_TOL}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
        del out, ref
        if L == 300:
            continue
        scale = tra.tied_scale(64, R)
        kernel = time_ms(lambda: tra.tied_row_attention_cuda(q, k, v, nh,
                                                             col_bias=bias))
        plain = time_ms(lambda: tra.tied_row_attention_plain(
            q, k, v, nh, col_bias=bias), iters=3)
        tied = lambda x: x.view(B, R, L, nh, 64).permute(0, 3, 2, 1, 4).reshape(
            B, nh, L, R * 64)
        qt, kt, vt, mask = tied(q), tied(k), tied(v), bias.to(torch.bfloat16)
        library = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale))
        del qt, kt, vt
        # the keys that carry weight: every query column reads them
        keys = sum(lens)
        row_bytes = R * nh * 64 * 2
        b_ms, b_by = bound_ms(2 * B * L * row_bytes + 2 * keys * row_bytes + B * L * 4,
                              4.0 * nh * L * keys * R * 64, BF16_FLOPS)
        tiles = sum(-(-n // 128) for n in lens) / (B * -(-L // 128))
        print(f"  tied-row timed at {shape}: kernel {kernel:.4f} ms, plain "
              f"{plain:.4f} ms, SDPA {library:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), key tiles visited {tiles:.1%}", flush=True)
        cases.append({"shape": shape, "ms": kernel, "plain_ms": plain,
                      "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
                      "key_tiles_visited": tiles})
        del q, k, v
        torch.cuda.empty_cache()
    row = cases[0]
    return {"name": "tied_row_attention", "route": "cuda",
            "source": "oneprot_tpu_torch/kernels/csrc/tied_row_attention.cu",
            "replaces": "oneprot_tpu/kernels/tied_row_attention.py:56",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "cases": cases[1:],
            "note": "library_ms: scaled_dot_product_attention on [B, H, L, "
                    "R*64] (heads of R*64), scale and column mask"}


def fa_inputs(B, H, L, D, gen):
    """q, k, v [B, H, L, D] bf16 as the ESM2 layer hands them over (heads
    viewed out of [B, L, H*D] projections), a key-padding bias [B, 1, 1, L]
    (each row keeps a random prefix of at least L/2 keys) and the valid
    positions [B, L]."""
    q, k, v = (torch.randn(B, L, H * D, device="cuda", generator=gen)
               .to(torch.bfloat16).view(B, L, H, D).transpose(1, 2)
               for _ in range(3))
    lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
    valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    return q, k, v, ((1.0 - valid.float()) * -1e9)[:, None, None, :], valid


def check_flash_attention(gen) -> dict:
    """The FlashAttention-2 forward against flash_attention_plain: at the
    ESM2-15B width's serving shape (a batch of 32 at bucket 1024, 40 heads
    of 128), at heads of 64 and 256, at a ragged L = 300, and on heads of 24
    through dot_product_attention's padding (the 35M tower's width), each
    with a key-padding bias. The first three are timed beside
    scaled_dot_product_attention on the same inputs and the bound."""
    worst_rel, worst_abs, worst_lse = 0.0, 0.0, 0.0
    timed = []
    cases = [(32, 40, 1024, 128, True), (8, 16, 1024, 64, True),
             (8, 16, 1024, 256, True), (4, 40, 300, 128, False),
             (16, 20, 1024, 24, False)]
    for B, H, L, D, time_it in cases:
        q, k, v, bias, valid = fa_inputs(B, H, L, D, gen)
        if D < fa.MIN_HEAD_DIM:  # padded to 64 on the way into the kernel
            out, lse = fa.dot_product_attention(q, k, v, bias), None
        else:
            out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias)
        ref, ref_lse_full = fa.flash_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        require(torch.isfinite(out.float()).all().item(),
                f"flash-attention D={D} L={L}: non-finite")
        diff = (out.float() - ref.float()).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-6)
        line = (f"  flash-attention B={B} H={H} L={L} D={D}"
                f"{' (padded to 64 by dot_product_attention)' if lse is None else ''}"
                f": max rel err {rel:.3e}, max abs err {diff:.3e}")
        require(rel <= FLASH_REL_TOL,
                f"flash-attention D={D} L={L}: rel err {rel} > {FLASH_REL_TOL}")
        if lse is not None:
            rows = valid[:, None, :].expand_as(lse)
            lse_err = (lse - ref_lse_full).abs()[rows].max().item()
            line += f", lse max abs err {lse_err:.3e} (real rows)"
            require(lse_err <= 5e-2, f"flash-attention D={D} L={L}: lse err "
                    f"{lse_err}")
            worst_lse = max(worst_lse, lse_err)
        print(line, flush=True)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
        del out, ref, ref_lse_full, lse
        if time_it:
            kernel = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, bias))
            plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, bias),
                            iters=3)
            mask = bias.to(torch.bfloat16)
            library = time_ms(lambda: torch.nn.functional.
                              scaled_dot_product_attention(q, k, v,
                                                           attn_mask=mask))
            # q, k, v read and out written in bf16, the bias and lse in f32
            nbytes = 4 * B * H * L * D * 2 + B * L * 4 + B * H * L * 4
            b_ms, b_by = bound_ms(nbytes, 4.0 * B * H * L * L * D, BF16_FLOPS)
            print(f"  flash-attention timed at B={B} H={H} L={L} D={D}: kernel "
                  f"{kernel:.4f} ms, plain {plain:.4f} ms, SDPA {library:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
            timed.append({"shape": f"B={B} H={H} L={L} D={D} bf16",
                          "ms": kernel, "plain_ms": plain,
                          "library_ms": library, "bound_ms": b_ms,
                          "bound_by": b_by})
        del q, k, v, bias
        torch.cuda.empty_cache()
    main = timed[0]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "oneprot_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
            "replaces": "oneprot_tpu/kernels/flash_attention.py:79",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "lse_max_abs_err": worst_lse, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "timed": timed,
            "note": "library_ms: scaled_dot_product_attention with the "
                    "[B, 1, 1, L] bias as a bf16 mask"}


def check_flash_attention_bwd(gen) -> list:
    """The FlashAttention-2 dq kernel (#6, its prologue included: q_s and
    delta) and dk/dv kernel (#7, on #6's q_s and delta) against
    flash_attention_bwd_plain on the same q, k, v, out, lse and upstream
    gradient (zero on padding rows, as the pooled loss gives it), q, k, v
    and the gradient as views of [B, L, H*D] tensors, and #6's q_s and delta
    against flash_attention_bwd_dq_plain's: at the LoRA-15B step's largest
    shape (a batch of 16 at bucket 1024, 40 heads of 128), at heads of 64
    and 256 and at a ragged L = 300, each with a key-padding bias. Timed at
    the first: each kernel beside its own plain version and the bound, and
    the whole card backward (flash_attention_bwd_cuda: #6, then #7) beside
    scaled_dot_product_attention's backward (forward + backward minus
    forward) and the bound of the backward's five products."""
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0, "delta": 0.0}
    worst_abs = dict(worst)
    cases = [(LORA_BATCH, 40, 1024, 128), (8, 16, 1024, 64),
             (8, 16, 1024, 256), (4, 40, 300, 128)]
    for B, H, L, D in cases:
        q, k, v, bias, valid = fa_inputs(B, H, L, D, gen)
        dout = (torch.randn(B, L, H, D, device="cuda", generator=gen)
                * valid[:, :, None, None]).to(torch.bfloat16).transpose(1, 2)
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias)
        dq, qs, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, bias, out, lse,
                                                       dout)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(qs, k, v, bias, dout, lse,
                                                 delta)
        ref = fa.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
        _, ref_qs, ref_delta = fa.flash_attention_bwd_dq_plain(
            q, k, v, bias, out, lse, dout)
        torch.cuda.synchronize()
        require(torch.equal(qs, ref_qs), f"flash-attention bwd q_s D={D} "
                f"L={L}: not q * bf16(1/sqrt(D))")
        diff = (delta - ref_delta).abs().max().item()
        rel = diff / max(ref_delta.abs().max().item(), 1e-6)
        require(rel <= FLASH_REL_TOL, f"flash-attention bwd delta D={D} "
                f"L={L}: rel err {rel} > {FLASH_REL_TOL}")
        worst["delta"] = max(worst["delta"], rel)
        worst_abs["delta"] = max(worst_abs["delta"], diff)
        errs = [f"delta {rel:.3e}"]
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            require(torch.isfinite(got.float()).all().item(),
                    f"flash-attention bwd {name} D={D} L={L}: non-finite")
            diff = (got.float() - want.float()).abs().max().item()
            rel = diff / max(want.float().abs().max().item(), 1e-6)
            require(rel <= FLASH_REL_TOL, f"flash-attention bwd {name} D={D} "
                    f"L={L}: rel err {rel} > {FLASH_REL_TOL}")
            worst[name] = max(worst[name], rel)
            worst_abs[name] = max(worst_abs[name], diff)
            errs.append(f"{name} {rel:.3e}")
        print(f"  flash-attention backward B={B} H={H} L={L} D={D}: max rel err "
              + ", ".join(errs), flush=True)
        del dq, dk, dv, ref, ref_qs, ref_delta
        if (B, H, L, D) == cases[0]:
            timed = (q, k, v, bias, dout, out, lse, qs, delta)
        del q, k, v, bias, dout, out, lse, qs, delta
        torch.cuda.empty_cache()

    q, k, v, bias, dout, out, lse, qs, delta = timed
    B, H, L, D = cases[0]
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, bias, out, lse, dout))
    dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
        qs, k, v, bias, dout, lse, delta))
    whole_ms = time_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, bias, out, lse, dout))
    plain_dq = time_ms(lambda: fa.flash_attention_bwd_dq_plain(
        q, k, v, bias, out, lse, dout), iters=3)
    plain_dkv = time_ms(lambda: fa.flash_attention_bwd_dkv_plain(
        qs, k, v, bias, dout, lse, delta), iters=3)
    leaves = [x.detach().contiguous().requires_grad_() for x in (q, k, v)]
    mask, do_c = bias.to(torch.bfloat16), dout.contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = time_ms(lambda: sdpa(*leaves, attn_mask=mask))
    fwd_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(*leaves, attn_mask=mask), leaves, do_c))
    library = fwd_bwd - fwd
    per_pair = B * H * L * L * D  # one [L, L] x D product, per head
    qkvo = B * H * L * D * 2      # one bf16 [B, H, L, D] tensor, in bytes
    row = B * H * L * 4           # one f32 [B, H, L] tensor (lse, delta)
    bias_bytes = B * L * 4
    # #6 reads q, k, v, out, dout, lse, bias and writes dq, q_s, delta; #7
    # reads q_s, k, v, dout, lse, delta, bias and writes dk, dv; the whole
    # backward reads what #6 reads and writes dq, dk, dv, and its least work
    # is five products (q k^T, dO v^T, dS k, dS^T q, p^T dO)
    whole_bound, whole_by = bound_ms(8 * qkvo + row + bias_bytes,
                                     10.0 * per_pair, BF16_FLOPS)
    rows = []
    for name, ms, plain, gemms, nbytes, line in (
            ("flash_attention_bwd_dq", dq_ms, plain_dq, 3,
             7 * qkvo + 2 * row + bias_bytes, 163),
            ("flash_attention_bwd_dkv", dkv_ms, plain_dkv, 4,
             6 * qkvo + 2 * row + bias_bytes, 192)):
        b_ms, b_by = bound_ms(nbytes, 2.0 * gemms * per_pair, BF16_FLOPS)
        grads = ("dq", "delta") if gemms == 3 else ("dk", "dv")
        print(f"  {name} timed at B={B} H={H} L={L} D={D}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"oneprot_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": f"oneprot_tpu/kernels/flash_attention.py:{line}",
            "max_abs_err": max(worst_abs[g] for g in grads),
            "max_rel_err": {g: worst[g] for g in grads},
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library, "shape": f"B={B} H={H} L={L} D={D} bf16",
            "whole_backward_ms": whole_ms, "whole_backward_bound_ms": whole_bound,
            "note": "plain_ms: this kernel's plain version (flash_attention_"
                    "bwd_dq_plain with the prologue, or flash_attention_bwd_"
                    "dkv_plain); library_ms: scaled_dot_product_attention "
                    "forward+backward minus its forward with the [B, 1, 1, "
                    "L] bias as a bf16 mask, one figure for the whole "
                    "backward; whole_backward_ms: flash_attention_bwd_cuda "
                    "(#6 with its prologue, then #7)"})
    print(f"  flash-attention backward: whole card backward {whole_ms:.4f} ms "
          f"(#6 + #7, prologue in #6; bound {whole_bound:.4f} ms, {whole_by}) "
          f"against SDPA backward {library:.4f} ms (fwd+bwd {fwd_bwd:.4f} - fwd "
          f"{fwd:.4f}): {whole_ms / library:.3f}x", flush=True)
    return rows


def check_flash_attention_segments(gen, rows: list) -> dict:
    """#5, #6 and #7 with segment ids on train_packed's real packed batch
    (`make_packed_batch` from PACKED_SEG_SEED: the hub's ids, 16 rows of
    1024, 16 slots) at the ESM2-15B width's heads (B=16 H=40 L=1024 D=128,
    bf16, the key-padding bias beside the ids), each against its plain
    version on the same ids (bf16 rel 1.5e-2; lse 5e-2 on the real rows;
    the padded rows finite), then timed beside its plain version, the
    share of tiles it visits (`segment_tile_hits` at its tile shapes), the
    needed-work bound over the pairs of equal ids and the dense one, and
    SDPA with the dense mask (the forward; the backward as forward +
    backward minus forward). And #5 at D = 256 (its mma.sync instance,
    which masks by the ids and visits every tile) on the batch's first 4
    rows, 16 heads. Folds the errors into `rows` and returns the numbers,
    which the rows of #5-#7 carry as `segment_ids`."""
    B, H, L, D = ROWS, 40, ROW_LEN, 128
    seg = torch.from_numpy(make_packed_batch(np.random.RandomState(
        PACKED_SEG_SEED))["seq"]["segment_ids"]).cuda()
    valid = seg >= 0
    bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
    q, k, v, _, _ = fa_inputs(B, H, L, D, gen)
    dout = (torch.randn(B, L, H, D, device="cuda", generator=gen)
            * valid[:, :, None, None]).to(torch.bfloat16).transpose(1, 2)
    by_name = {r["name"]: r for r in rows}

    def worse(name, key, value):
        row = by_name[name]
        if isinstance(row[key], dict):
            return
        row[key] = max(row[key], value)

    def rel_err(got, want):
        diff = (got.float() - want.float()).abs().max().item()
        return diff / max(want.float().abs().max().item(), 1e-6), diff

    out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias, seg)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bias, seg)
    dq, qs, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, bias, out, lse,
                                                   dout, seg)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(qs, k, v, bias, dout, lse, delta,
                                             seg)
    torch.cuda.synchronize()
    require(torch.isfinite(out.float()).all().item()
            and torch.isfinite(lse).all().item(),
            "flash-attention with segment ids: non-finite out or lse (the "
            "padded rows included)")
    errs = {}
    errs["out"], abs_out = rel_err(out, ref)
    real = valid[:, None, :].expand_as(lse)
    errs["lse"] = (lse - ref_lse).abs()[real].max().item()
    require(errs["out"] <= FLASH_REL_TOL, f"#5 with segment ids: rel err "
            f"{errs['out']}")
    require(errs["lse"] <= 5e-2, f"#5 with segment ids: lse err {errs['lse']}")
    worse("flash_attention_fwd", "max_rel_err", errs["out"])
    worse("flash_attention_fwd", "max_abs_err", abs_out)
    worse("flash_attention_fwd", "lse_max_abs_err", errs["lse"])
    del ref, ref_lse
    own_dq, own_qs, own_delta = fa.flash_attention_bwd_dq_plain(
        q, k, v, bias, out, lse, dout, seg)
    require(torch.equal(qs, own_qs), "#6 with segment ids: q_s")
    errs["delta"] = rel_err(delta, own_delta)[0]
    del own_qs, own_delta
    own_dk, own_dv = fa.flash_attention_bwd_dkv_plain(qs, k, v, bias, dout,
                                                      lse, delta, seg)
    whole = fa.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout, seg)
    torch.cuda.synchronize()
    for name, got, wants, kernel in (
            ("dq", dq, (own_dq, whole[0]), "flash_attention_bwd_dq"),
            ("dk", dk, (own_dk, whole[1]), "flash_attention_bwd_dkv"),
            ("dv", dv, (own_dv, whole[2]), "flash_attention_bwd_dkv")):
        require(torch.isfinite(got.float()).all().item(),
                f"{kernel} with segment ids: non-finite {name}")
        for want in wants:
            rel, diff = rel_err(got, want)
            require(rel <= FLASH_REL_TOL, f"{kernel} with segment ids: {name} "
                    f"rel err {rel}")
            errs[name] = max(errs.get(name, 0.0), rel)
            worse(kernel, "max_abs_err", diff)
    require(errs["delta"] <= FLASH_REL_TOL, f"#6 with segment ids: delta rel "
            f"err {errs['delta']}")
    del own_dq, own_dk, own_dv, whole, dq, dk, dv
    torch.cuda.empty_cache()

    fwd_ms = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, bias, seg))
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, bias, out, lse, dout, seg))
    dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
        qs, k, v, bias, dout, lse, delta, seg))
    plain = {"fwd": time_ms(lambda: fa.flash_attention_plain(
        q, k, v, bias, seg), iters=3),
        "dq": time_ms(lambda: fa.flash_attention_bwd_dq_plain(
            q, k, v, bias, out, lse, dout, seg), iters=3),
        "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv_plain(
            qs, k, v, bias, dout, lse, delta, seg), iters=3)}
    mask = flash_mha.packed_segment_bias(seg, bias, mask_value=-1e30).to(
        torch.bfloat16)
    leaves = [x.detach().contiguous().requires_grad_() for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = time_ms(lambda: sdpa(*leaves, attn_mask=mask))
    sdpa_fwd_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(*leaves, attn_mask=mask), leaves, dout.contiguous()))
    del leaves, mask
    tiles = {"fwd": flash_mha.segment_tile_hits(
        seg, fa.fwd_key_tile(D), fa.BLOCK).float().mean().item(),
        "dq": flash_mha.segment_tile_hits(seg, fa.TILE,
                                          fa.BLOCK).float().mean().item()}
    tiles["dkv"] = tiles["dq"]  # the same table read key block first
    pairs = needed_pairs(seg, B, L) * H
    dense = B * H * L * L
    qkvo = B * H * L * D * 2
    row = B * H * L * 4
    side = B * L * 4 * 2  # the bias and the ids
    out_ = {"shape": f"B={B} H={H} L={L} D={D} bf16, the real packed batch "
                     f"(PACKED_SEG_SEED), {SLOTS} slots a row",
            "max_rel_err": errs, "pairs_needed": pairs / dense,
            "sdpa_forward_ms": sdpa_fwd,
            "sdpa_backward_ms": sdpa_fwd_bwd - sdpa_fwd, "kernels": {}}
    for name, ms, gemms, nbytes in (
            ("flash_attention_fwd", fwd_ms, 2, 4 * qkvo + row + side),
            ("flash_attention_bwd_dq", dq_ms, 3, 7 * qkvo + 2 * row + side),
            ("flash_attention_bwd_dkv", dkv_ms, 4, 6 * qkvo + 2 * row + side)):
        part = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dq": "dq",
                "flash_attention_bwd_dkv": "dkv"}[name]
        b_ms, b_by = bound_ms(nbytes, 2.0 * gemms * pairs * D, BF16_FLOPS)
        dense_ms = bound_ms(nbytes, 2.0 * gemms * dense * D, BF16_FLOPS)[0]
        out_["kernels"][name] = {
            "ms": ms, "plain_ms": plain[part], "tiles_visited": tiles[part],
            "bound_ms": b_ms, "bound_by": b_by, "dense_bound_ms": dense_ms,
            "library_ms": sdpa_fwd if part == "fwd" else
            sdpa_fwd_bwd - sdpa_fwd}
        print(f"  {name} with segment ids, {out_['shape']}: {ms:.4f} ms "
              f"(plain {plain[part]:.4f} ms); tiles visited "
              f"{tiles[part]:.3f}, pairs needed {pairs / dense:.3f}; bound "
              f"(needed / dense) {b_ms:.4f} / {dense_ms:.4f} ms ({b_by}); "
              f"SDPA with the dense mask "
              + (f"forward {sdpa_fwd:.4f} ms" if part == "fwd" else
                 f"backward {sdpa_fwd_bwd - sdpa_fwd:.4f} ms (both passes)"),
              flush=True)
    print(f"  FA-2 with segment ids: max rel err " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + "; #6 + #7 "
        f"{dq_ms + dkv_ms:.4f} ms against SDPA's backward "
        f"{sdpa_fwd_bwd - sdpa_fwd:.4f} ms", flush=True)
    del q, k, v, out, lse, qs, delta, dout
    torch.cuda.empty_cache()

    # D = 256: the mma.sync instance takes the ids as a mask
    b4, h4 = 4, 16
    seg4, bias4 = seg[:b4].contiguous(), bias[:b4].contiguous()
    q, k, v, _, _ = fa_inputs(b4, h4, L, 256, gen)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias4, seg4)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bias4, seg4)
    torch.cuda.synchronize()
    rel, diff = rel_err(out, ref)
    lse_err = (lse - ref_lse).abs()[valid[:b4, None, :].expand_as(lse)].max(
    ).item()
    require(torch.isfinite(out.float()).all().item() and rel <= FLASH_REL_TOL
            and lse_err <= 5e-2, f"#5 D=256 with segment ids: rel err {rel}, "
            f"lse err {lse_err}")
    worse("flash_attention_fwd", "max_rel_err", rel)
    worse("flash_attention_fwd", "max_abs_err", diff)
    ms = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, bias4, seg4))
    pairs4 = needed_pairs(seg4, b4, L) * h4
    b_ms, b_by = bound_ms(4 * b4 * h4 * L * 256 * 2 + b4 * h4 * L * 4
                          + b4 * L * 8, 4.0 * pairs4 * 256, BF16_FLOPS)
    out_["d256_forward"] = {"shape": f"B={b4} H={h4} L={L} D=256 bf16",
                            "ms": ms, "max_rel_err": rel,
                            "lse_max_abs_err": lse_err, "bound_ms": b_ms,
                            "bound_by": b_by}
    print(f"  flash_attention_fwd D=256 with segment ids (mma.sync, every "
          f"tile), B={b4} H={h4} L={L}: max rel err {rel:.3e}, lse {lse_err:.3e};"
          f" {ms:.4f} ms, needed-work bound {b_ms:.4f} ms ({b_by})", flush=True)
    del q, k, v, out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    common = {k: out_[k] for k in ("shape", "max_rel_err", "pairs_needed")}
    for name, numbers in out_["kernels"].items():
        by_name[name]["segment_ids"] = {**common, **numbers}
    by_name["flash_attention_fwd"]["segment_ids"]["d256"] = out_[
        "d256_forward"]
    return out_


def check_flash_packed(out, lse, q, k, v, H, side, valid, fwd_row, what):
    """The forward kernel's out and lse at a training shape against
    mha_attention_plain on the same inputs; folds the errors into the
    forward kernel's row."""
    ref, ref_lse = flash_mha.mha_attention_plain(q, k, v, H, **side)
    torch.cuda.synchronize()
    require(torch.isfinite(out.float()).all().item(), f"flash {what}: non-finite")
    diff = (out.float() - ref.float()).abs().max().item()
    rel = diff / max(ref.float().abs().max().item(), 1e-6)
    lse_err = (lse - ref_lse).abs()[valid[:, None, :].expand_as(lse)].max().item()
    print(f"  flash-MHA {what}: max rel err {rel:.3e}, max abs err {diff:.3e}, "
          f"lse max abs err {lse_err:.3e} (real rows)", flush=True)
    require(rel <= FLASH_REL_TOL, f"flash {what}: rel err {rel} > {FLASH_REL_TOL}")
    require(lse_err <= 5e-2, f"flash {what}: lse err {lse_err}")
    fwd_row["max_rel_err"] = max(fwd_row["max_rel_err"], rel)
    fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], diff)
    fwd_row["lse_max_abs_err"] = max(fwd_row["lse_max_abs_err"], lse_err)


def packed_struct_segments(seed: int = PACKED_SEG_SEED):
    """Struct-token segment ids [ROWS, ROW_LEN] (-1 on padding) of a packed
    batch as `make_packed_batch` draws it, from its own numpy seed."""
    return make_packed_batch(np.random.RandomState(seed))["mod"]["segment_ids"]


def sdpa_heads(x, H, cos=None, sin=None) -> torch.Tensor:
    """[B, L, H*D] -> bf16 [B, H, L, D], rotated when tables are given."""
    B, L, hd = x.shape
    xh = x.view(B, L, H, hd // H).transpose(1, 2)
    if cos is None:
        return xh.contiguous()
    return flash_mha.apply_rotary(xh.float(), cos, sin).to(torch.bfloat16)


def sdpa_backward_ms(q, k, v, cos, sin, mask, dout, H):
    """scaled_dot_product_attention's backward (forward + backward minus
    forward) on pre-rotated [B, H, L, D] inputs with a dense bf16 mask:
    (backward ms, forward + backward ms, forward ms)."""
    B, L, hd = q.shape
    D = hd // H
    heads = lambda x: x.view(B, L, H, D).transpose(1, 2)
    qr, kr = sdpa_heads(q, H, cos, sin), sdpa_heads(k, H, cos, sin)
    leaves = [x.detach().contiguous().requires_grad_() for x in (qr, kr, heads(v))]
    do_h = heads(dout).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = time_ms(lambda: sdpa(*leaves, attn_mask=mask))
    fwd_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(*leaves, attn_mask=mask), leaves, do_h))
    return fwd_bwd - fwd, fwd_bwd, fwd


def needed_pairs(seg, B: int, L: int) -> int:
    """(query, key) pairs of one head that the backward must compute: the
    pairs of equal segment ids (same protein, or padding with padding), or
    all L^2 without segment ids."""
    if seg is None:
        return B * L * L
    s = seg.long()
    return int(sum((row[:, None] == row[None, :]).sum().item() for row in s))


def check_flash_bwd(gen, fwd_row: dict) -> list:
    """The dq kernel (#2, its prologue included: q_r and delta) and the
    dk/dv kernel (#3, on #2's q_r and delta) against the plain backward on
    the same q, k, v, out, lse and upstream gradient (zero on padding rows,
    as a loss over pooled segments gives it), and each against its own
    plain version (flash_mha_bwd_dq_plain: q_r equal, delta;
    flash_mha_bwd_dkv_plain on the kernel's q_r and delta): at the 35M
    tower's packed shape (16 rows of 1024, 20 heads of 24, rotary, padding
    bias, 16 proteins a row), at the hub's packed shape (heads of 64), at
    L=512 with 4 proteins a row, at the tower's unpacked shape in the LoRA
    step (16 rows of 1024, key padding bias, no segment ids), and on the
    struct-token segment ids of a real packed batch (`make_packed_batch`).
    The forward kernel's out and lse at each of these shapes are first held
    against the plain forward (`check_flash_packed`). Each case is timed:
    #2, #3 and the whole card backward (`flash_mha_bwd_cuda`) beside SDPA's
    backward, with the share of 64 x 64 tiles the kernels visit and the
    bound over the logit pairs these inputs need (same segment, or padding
    with padding) beside the dense one, and the exp2 floor at the card's
    special-function rate. The kernels' row carries the first case."""
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0, "delta": 0.0}
    worst_abs = dict(worst)
    H = 20
    cases = [(ROWS, ROW_LEN, 24, SLOTS), (ROWS, ROW_LEN, 64, SLOTS),
             (16, 512, 64, 4), (LORA_BATCH, ROW_LEN, 24, 0),
             (ROWS, ROW_LEN, 24, "real")]
    timings = []
    for B, L, D, n_seg in cases:
        q, k, v, bias, cos, sin, seg, valid = attention_inputs(
            B, L, H, D, gen, segments=n_seg not in (0, "real"),
            n_seg=n_seg if isinstance(n_seg, int) else 0)
        if n_seg == "real":  # padding and segments of the real packing
            seg = torch.from_numpy(packed_struct_segments()).cuda()
            valid = seg >= 0
            bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
            layout = "real packed batch"
        else:
            layout = f"{n_seg} segments a row" if n_seg else "unpacked"
        side = dict(bias=bias, rope_cos=cos, rope_sin=sin, segment_ids=seg)
        dout = (torch.randn(B, L, H * D, device="cuda", generator=gen)
                * valid[..., None]).to(torch.bfloat16)
        out, lse = flash_mha.flash_mha_cuda(q, k, v, H, **side)
        what = f"B={B} L={L} H={H} D={D} {layout}"
        check_flash_packed(out, lse, q, k, v, H, side, valid, fwd_row, what)
        fwd_row["cases"].append(time_flash_fwd(what, q, k, v, H, side))
        dq, q_r, delta = flash_mha.flash_mha_bwd_dq_cuda(q, k, v, out, lse, dout,
                                                        H, **side)
        dk, dv = flash_mha.flash_mha_bwd_dkv_cuda(q_r, k, v, dout, lse, delta, H,
                                                  **side)
        ref = flash_mha.mha_attention_bwd_plain(q, k, v, out, lse, dout, H, **side)
        own_dq, own_qr, own_delta = flash_mha.flash_mha_bwd_dq_plain(
            q, k, v, out, lse, dout, H, **side)
        own_dkv = flash_mha.flash_mha_bwd_dkv_plain(q_r, k, v, dout, lse, delta,
                                                    H, **side)
        torch.cuda.synchronize()
        require(torch.equal(q_r, own_qr), f"flash bwd q_r {what}: not "
                "bf16(rot(q) * q_pre)")
        diff = (delta - own_delta).abs().max().item()
        rel = diff / max(own_delta.abs().max().item(), 1e-6)
        require(rel <= FLASH_REL_TOL, f"flash bwd delta {what}: rel err {rel}")
        worst["delta"], worst_abs["delta"] = (max(worst["delta"], rel),
                                              max(worst_abs["delta"], diff))
        errs = [f"delta {rel:.3e}"]
        for name, got, want, own in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                        (own_dq, *own_dkv)):
            require(torch.isfinite(got.float()).all().item(),
                    f"flash bwd {name} {what}: non-finite")
            for r in (want, own):
                diff = (got.float() - r.float()).abs().max().item()
                rel = diff / max(r.float().abs().max().item(), 1e-6)
                require(rel <= FLASH_REL_TOL,
                        f"flash bwd {name} {what}: rel err {rel} > {FLASH_REL_TOL}")
                worst[name] = max(worst[name], rel)
                worst_abs[name] = max(worst_abs[name], diff)
            errs.append(f"{name} {rel:.3e}")
        print(f"  flash-MHA backward {what}: max rel err " + ", ".join(errs),
              flush=True)
        del ref, own_dq, own_qr, own_delta, own_dkv, dq, dk, dv
        timings.append(time_flash_bwd(what, q, k, v, out, lse, dout, H, side,
                                      q_r, delta))
        del q, k, v, out, lse, dout, q_r, delta, side
        torch.cuda.empty_cache()

    t = timings[0]
    rows = []
    for name, ms, gemms, line in (
            ("flash_mha_bwd_dq", t["dq_ms"], 3, 512),
            ("flash_mha_bwd_dkv", t["dkv_ms"], 4, 619)):
        grads = ("dq", "delta") if gemms == 3 else ("dk", "dv")
        part = name.split("_")[-1]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"oneprot_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": f"oneprot_tpu/kernels/flash_mha.py:{line}",
            "max_abs_err": max(worst_abs[g] for g in grads),
            "max_rel_err": {g: worst[g] for g in grads},
            "ms": ms, "plain_ms": t[f"{part}_plain_ms"],
            "bound_ms": t[f"{part}_bound_ms"], "bound_by": t[f"{part}_bound_by"],
            "dense_bound_ms": t[f"{part}_dense_bound_ms"],
            "exp2_floor_ms": t["exp2_floor_ms"],
            "library_ms": t["sdpa_backward_ms"],
            "shape": f"B={ROWS} L={ROW_LEN} H={H} D=24 bf16, {SLOTS} segments a row",
            "cases": timings,
            "note": "bound_ms: operations over the logit pairs these inputs "
                    "need (equal segment ids), dense_bound_ms over all L^2; "
                    "plain_ms: this kernel's own plain version; library_ms: "
                    "scaled_dot_product_attention forward+backward minus "
                    "its forward with the dense mask, one figure for both "
                    "passes; cases: every timed case, the whole card "
                    "backward (flash_mha_bwd_cuda) beside SDPA's"})
    return rows


def time_flash_fwd(what, q, k, v, H, side) -> dict:
    """#1 and SDPA's forward on one case (pre-rotated heads, the bias or
    the dense segment mask as a bf16 mask), with the share of the kernel's
    query-block x key-tile pairs it visits and the needed-work and dense
    bounds; prints one line and returns the numbers."""
    B, L, hd = q.shape
    D = hd // H
    seg = side["segment_ids"]
    ms = time_ms(lambda: flash_mha.flash_mha_cuda(q, k, v, H, **side))
    mask = side["bias"]
    if seg is not None:
        mask = flash_mha.packed_segment_bias(seg, mask, mask_value=-1e30)
    rot = side["rope_cos"], side["rope_sin"]
    qr, kr = sdpa_heads(q, H, *rot), sdpa_heads(k, H, *rot)
    vh, m16 = sdpa_heads(v, H), mask.to(torch.bfloat16)
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vh, attn_mask=m16))
    del qr, kr, vh, m16
    tiles = (1.0 if seg is None else flash_mha.segment_tile_hits(
        seg, flash_mha.fwd_key_tile(D), flash_mha.FWD_Q_TILE).float().mean().item())
    pairs = needed_pairs(seg, B, L) * H
    dense = B * L * L * H
    # q, k, v read and out written in bf16; lse out, bias and ids in f32 /
    # int32, both rotary tables in bf16 where there are tables
    nbytes = (4 * B * L * H * D * 2 + B * H * L * 4
              + B * L * 4 * (2 if seg is not None else 1)
              + (0 if rot[0] is None else 2 * L * D * 2))
    b_ms, b_by = bound_ms(nbytes, 4.0 * pairs * D, BF16_FLOPS)
    dense_ms = bound_ms(nbytes, 4.0 * dense * D, BF16_FLOPS)[0]
    print(f"  flash-MHA forward timed, {what}: #1 {ms:.4f} ms against SDPA "
          f"forward {sdpa:.4f} ms: {ms / sdpa:.3f}x; tiles visited {tiles:.3f}, "
          f"pairs needed {pairs / dense:.3f}; bound (needed / dense) "
          f"{b_ms:.4f} / {dense_ms:.4f} ms ({b_by})", flush=True)
    return {"case": what, "ms": ms, "sdpa_forward_ms": sdpa,
            "tiles_visited": tiles, "pairs_needed": pairs / dense,
            "bound_ms": b_ms, "bound_by": b_by, "dense_bound_ms": dense_ms}


def time_flash_bwd(what, q, k, v, out, lse, dout, H, side, q_r, delta) -> dict:
    """#2, #3, the whole card backward and SDPA's backward on one case, with
    the needed-work and dense bounds, the exp2 floor and the share of tiles
    the kernels visit; prints one line and returns the numbers."""
    B, L, hd = q.shape
    D = hd // H
    seg = side["segment_ids"]
    dq_ms = time_ms(lambda: flash_mha.flash_mha_bwd_dq_cuda(
        q, k, v, out, lse, dout, H, **side))
    dkv_ms = time_ms(lambda: flash_mha.flash_mha_bwd_dkv_cuda(
        q_r, k, v, dout, lse, delta, H, **side))
    whole_ms = time_ms(lambda: flash_mha.flash_mha_bwd_cuda(
        q, k, v, out, lse, dout, H, **side))
    dq_plain = time_ms(lambda: flash_mha.flash_mha_bwd_dq_plain(
        q, k, v, out, lse, dout, H, **side), iters=3)
    dkv_plain = time_ms(lambda: flash_mha.flash_mha_bwd_dkv_plain(
        q_r, k, v, dout, lse, delta, H, **side), iters=3)
    mask = side["bias"]
    if seg is not None:
        mask = flash_mha.packed_segment_bias(seg, mask, mask_value=-1e30)
    sdpa_ms, sdpa_fwd_bwd, sdpa_fwd = sdpa_backward_ms(
        q, k, v, side["rope_cos"], side["rope_sin"], mask.to(torch.bfloat16),
        dout, H)
    pairs = needed_pairs(seg, B, L) * H  # over every head
    dense = B * L * L * H
    tiles = 1.0 if seg is None else flash_mha.segment_tile_hits(seg).float().mean().item()
    qkvo = B * L * H * D * 2  # one bf16 [B, L, H*D] tensor, in bytes
    row = B * H * L * 4       # one f32 [B, H, L] tensor (lse, delta)
    side_bytes = (B * L * 4 * (2 if seg is not None else 1)
                  + (0 if side["rope_cos"] is None else 2 * L * D * 2))
    # #2 reads q, k, v, out, dout, lse and writes dq, q_r, delta; #3 reads
    # q_r, k, v, dout, lse, delta and writes dk, dv; the whole backward
    # reads what #2 reads and writes dq, dk, dv, its least work five
    # products (q k^T, dO v^T, dS k, dS^T q, p^T dO) and one exp2 a pair
    res = {"case": what, "dq_ms": dq_ms, "dkv_ms": dkv_ms, "whole_ms": whole_ms,
           "dq_plain_ms": dq_plain, "dkv_plain_ms": dkv_plain,
           "sdpa_backward_ms": sdpa_ms, "tiles_visited": tiles,
           "pairs_needed": pairs / dense,
           "exp2_floor_ms": pairs / SFU_EXP2_S * 1e3}
    for name, gemms, nbytes in (("dq", 3, 7 * qkvo + 2 * row + side_bytes),
                                ("dkv", 4, 6 * qkvo + 2 * row + side_bytes),
                                ("whole", 5, 8 * qkvo + row + side_bytes)):
        b_ms, b_by = bound_ms(nbytes, 2.0 * gemms * pairs * D, BF16_FLOPS)
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = b_ms, b_by
        res[f"{name}_dense_bound_ms"] = bound_ms(
            nbytes, 2.0 * gemms * dense * D, BF16_FLOPS)[0]
    print(f"  flash-MHA backward timed, {what}: #2 {dq_ms:.4f} ms (plain "
          f"{dq_plain:.4f}), #3 {dkv_ms:.4f} ms (plain {dkv_plain:.4f}), whole "
          f"{whole_ms:.4f} ms against SDPA backward {sdpa_ms:.4f} ms (fwd+bwd "
          f"{sdpa_fwd_bwd:.4f} - fwd {sdpa_fwd:.4f}): {whole_ms / sdpa_ms:.3f}x; "
          f"tiles visited {tiles:.3f}, pairs needed {pairs / dense:.3f}; bounds "
          f"(needed / dense) #2 {res['dq_bound_ms']:.4f} / "
          f"{res['dq_dense_bound_ms']:.4f} ms ({res['dq_bound_by']}), #3 "
          f"{res['dkv_bound_ms']:.4f} / {res['dkv_dense_bound_ms']:.4f} ms "
          f"({res['dkv_bound_by']}), whole {res['whole_bound_ms']:.4f} / "
          f"{res['whole_dense_bound_ms']:.4f} ms ({res['whole_bound_by']}); "
          f"exp2 floor {res['exp2_floor_ms']:.4f} ms a kernel", flush=True)
    return res


def make_packed_batch(rng, rows: int = ROWS, row_len: int = ROW_LEN,
                      slots: int = SLOTS, median: float = 290.0):
    """`rows` rows of `row_len` tokens, `slots` slots a row, as bench.py
    packs them (ROWS x ROW_LEN, SLOTS by default): log-normal lengths
    around `median` residues clipped to [30, row_len], proteins added while
    they fit (a protein that does not is skipped; 20 misses in a row end
    the batch). Hub tokens 4..23 and struct tokens 20..52 between <cls>
    and <eos>, the same proteins in the same slots."""
    lengths, misses = [], 0
    while misses < 20:
        n = int(np.clip(rng.lognormal(np.log(median), 0.65), 30, row_len))
        if len(packing.pack_lengths(lengths + [n], row_len, slots)) > rows:
            misses += 1
            continue
        lengths.append(n)
        misses = 0
    seq_tok, st_tok = [], []
    for n in lengths:
        t = rng.randint(4, 24, size=n).astype(np.int32)
        t2 = rng.randint(20, 53, size=n).astype(np.int32)
        t[0] = t2[0] = 0
        t[-1] = t2[-1] = 2
        seq_tok.append(t)
        st_tok.append(t2)
    ids, seg, valid, members_of = packing.pack_token_rows(seq_tok, row_len,
                                                          slots)
    st_ids = np.full_like(ids, 1)
    st_seg = np.full_like(seg, -1)
    for r, members in enumerate(members_of):
        off = 0
        for slot, idx in enumerate(members):
            n = len(st_tok[idx])
            st_ids[r, off:off + n] = st_tok[idx]
            st_seg[r, off:off + n] = slot
            off += n
    require(ids.shape == (rows, row_len), f"packed batch {ids.shape}")
    return {"seq": {"ids": ids, "segment_ids": seg},
            "mod": {"ids": st_ids, "segment_ids": st_seg}, "valid": valid}


def build_module(hub: SequenceEncoder, tower: StructTokenEncoder) -> OneProtModule:
    """bench.py's module: CLIP + L1 regularizer, Adam after global norm
    clipping at 1.0 (at SMOKE_LR)."""
    return OneProtModule({"sequence": hub, "struct_token": tower},
                         optimizer=lambda: adam(SMOKE_LR), loss_fn="CLIP",
                         use_l1_regularization=True).init()


def run_steps(module: OneProtModule, batch: dict, seq_pooled=None):
    """STEPS train steps on one batch (packed, or cached with the hub's
    pooled features); returns (losses, seconds per step)."""
    losses, secs = [], []
    for _ in range(STEPS):
        t = time.time()
        if seq_pooled is None:
            loss, _ = module.train_step_packed("struct_token", batch["seq"],
                                               batch["mod"], batch["valid"])
        else:
            loss, _ = module.train_step_packed_cached(
                "struct_token", seq_pooled, batch["mod"], batch["valid"])
        losses.append(loss.item())  # waits for the step
        secs.append(time.time() - t)
    require(bool(np.isfinite(losses).all()), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return losses, secs


def training(hub: SequenceEncoder, rng, launches: dict):
    """The packed and the cached step at full width; fills `launches`.
    Returns (numbers, (the hub's and the tower's first 2 layers as they were
    before the first step, the tower's config), the batch)."""
    tower = create_struct_token_encoder()
    esm2.init_esm2_weights_(tower, torch.Generator(device="cuda").manual_seed(1))
    module = build_module(hub, tower)
    initial = (first_layers(hub.state_dict(), 2),
               first_layers(tower.state_dict(), 2), tower.config)
    batch = make_packed_batch(rng)
    pairs = int(batch["valid"].sum())
    fill = float((batch["seq"]["segment_ids"] >= 0).mean())
    print(f"  packed batch: {ROWS} rows x {ROW_LEN} tokens, {pairs} proteins, "
          f"{100 * fill:.1f}% of tokens real", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result = {"pairs_per_step": pairs, "token_fill": fill}
    tower_bwd = {**{name: 0 for name in LAUNCHERS},
                 "flash_mha_bwd_dq": TOWER_LAYERS,
                 "flash_mha_bwd_dkv": TOWER_LAYERS}
    per_step = {"packed step": {**tower_bwd,
                                "flash_mha_fwd": N_LAYERS + TOWER_LAYERS},
                "cached step": {**tower_bwd, "flash_mha_fwd": TOWER_LAYERS}}
    seq_pooled = None
    for path in ("packed step", "cached step"):
        if path == "cached step":
            seq_pooled = module.encode_packed_pooled(
                "sequence", batch["seq"]["ids"], batch["seq"]["segment_ids"],
                SLOTS)
            torch.cuda.synchronize()
        reset_launches()
        losses, secs = run_steps(module, batch, seq_pooled)
        launches[path] = read_launches()
        want = {k: STEPS * n for k, n in per_step[path].items()}
        require(launches[path] == want,
                f"{path} launches {launches[path]}, want {want}")
        require(not any(PLAIN_CALLS.values()),
                f"{path}: plain versions ran on the card: {PLAIN_CALLS}")
        med = float(np.median(secs))
        print(f"  {path}: losses " + ", ".join(f"{x:.4f}" for x in losses)
              + f"; step ms " + ", ".join(f"{x * 1e3:.1f}" for x in secs)
              + f"; median {med * 1e3:.1f} ms = {pairs / med:.1f} pairs/s; "
              f"launches {launches[path]}", flush=True)
        key = path.split()[0]
        result[key] = {"losses": losses, "step_ms": [x * 1e3 for x in secs],
                       "median_step_ms": med * 1e3, "pairs_per_s": pairs / med}
    result["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory over both paths: {result['peak_gib']:.2f} GiB",
          flush=True)
    return result, initial, batch


def first_layers(state: dict, n: int) -> dict:
    """A transformer state cut to its first n layers, on the CPU."""
    return {k: v.detach().cpu().clone() for k, v in state.items()
            if ".layers." not in k or int(k.split(".layers.")[1].split(".")[0]) < n}


def flat(tensors) -> torch.Tensor:
    """One f64 vector on the CPU: cosines over ~4e7 elements need more than
    f32 sums."""
    return torch.cat([t.detach().cpu().double().reshape(-1) for t in tensors])


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def training_parity(hub_state: dict, tower_state: dict, hub_cfg, tower_cfg,
                    batch: dict) -> dict:
    """One packed step at 2 hub + 2 tower layers from the same weights and
    PARITY_ROWS rows of the batch: card (bf16, kernels) vs CPU (f32, plain
    versions); then cached == uncached on the card."""
    small = {"seq": {k: v[:PARITY_ROWS] for k, v in batch["seq"].items()},
             "mod": {k: v[:PARITY_ROWS] for k, v in batch["mod"].items()},
             "valid": batch["valid"][:PARITY_ROWS]}
    cfg_h = dataclasses.replace(hub_cfg, num_layers=2)
    cfg_t = dataclasses.replace(tower_cfg, num_layers=2)
    state = {**{"encoders.sequence." + k: v for k, v in hub_state.items()},
             **{"encoders.struct_token." + k: v for k, v in tower_state.items()}}

    def module_on(device, dtype):
        m = build_module(
            SequenceEncoder(cfg_h, 1024, proj_type="mlp", device=device,
                            dtype=dtype),
            StructTokenEncoder(cfg_t, 1024, device=device, dtype=dtype))
        m.model.load_state_dict(state)
        return m

    def heads_of(m):
        return {name: flat(p for n, p in m.model.named_parameters()
                           if n.startswith(f"encoders.{name}.head."))
                for name in ("sequence", "struct_token")}

    out = {}
    runs = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        m = module_on(device, dtype)
        before = heads_of(m)
        loss, _ = m.train_step_packed("struct_token", small["seq"], small["mod"],
                                      small["valid"])
        after = heads_of(m)
        runs[device] = {
            "loss": loss.item(),
            "grad": {n: p.grad for n, p in m.model.named_parameters()
                     if p.grad is not None},
            "update": {k: after[k] - before[k] for k in after}}
    card, cpu = runs["cuda"], runs["cpu"]
    require(card["grad"].keys() == cpu["grad"].keys(), "gradient leaves differ")
    out["loss_card"], out["loss_cpu"] = card["loss"], cpu["loss"]
    out["loss_rel_diff"] = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    out["grad_cosine"] = cosine(flat(card["grad"].values()),
                                flat(cpu["grad"].values()))
    leaf_cos = {n: cosine(flat([card["grad"][n]]), flat([cpu["grad"][n]]))
                for n in card["grad"]}
    # the tower's attention projection weights, leaf by leaf: their
    # gradients pass through the dq and dk/dv kernels, and the heads'
    # larger leaves cannot hide them
    qkv = {n: c for n, c in leaf_cos.items()
           if n.startswith("encoders.struct_token.transformer.layers.")
           and n.split(".")[-2] in ("q", "k", "v") and n.endswith(".weight")}
    require(len(qkv) == 2 * 3, f"tower q/k/v gradient leaves: {sorted(qkv)}")
    out["tower_qkv_grad_cosine"] = qkv
    out["min_leaf_grad_cosine"] = min(leaf_cos.values())
    out["head_update_cosine"] = {k: cosine(card["update"][k], cpu["update"][k])
                                 for k in card["update"]}
    print(f"  one packed step, card vs CPU: loss {card['loss']:.6f} vs "
          f"{cpu['loss']:.6f} (rel diff {out['loss_rel_diff']:.2e}, gate "
          f"<= 2e-2); clipped-gradient cosine {out['grad_cosine']:.5f} (gate "
          f">= 0.99); tower q/k/v weight gradient cosine per leaf, least "
          f"{min(qkv.values()):.5f} (gate >= 0.99); least over all "
          f"{len(leaf_cos)} leaves {out['min_leaf_grad_cosine']:.5f} "
          f"(reported); head update cosine {out['head_update_cosine']} (gate "
          f">= 0.95)", flush=True)
    require(out["loss_rel_diff"] <= 2e-2, f"loss parity {out['loss_rel_diff']}")
    require(out["grad_cosine"] >= 0.99, f"gradient parity {out['grad_cosine']}")
    require(min(qkv.values()) >= 0.99, f"tower q/k/v gradient parity {qkv}")
    require(min(out["head_update_cosine"].values()) >= 0.95,
            f"head update parity {out['head_update_cosine']}")

    a, b = module_on("cuda", torch.bfloat16), module_on("cuda", torch.bfloat16)
    p0 = flat(a.opt.params)
    loss_a, _ = a.train_step_packed("struct_token", small["seq"], small["mod"],
                                    small["valid"])
    pooled = b.encode_packed_pooled("sequence", small["seq"]["ids"],
                                    small["seq"]["segment_ids"], SLOTS)
    loss_b, _ = b.train_step_packed_cached("struct_token", pooled, small["mod"],
                                           small["valid"])
    pa, pb = flat(a.opt.params), flat(b.opt.params)
    out["cached_loss_rel_diff"] = abs(loss_a.item() - loss_b.item()) / abs(
        loss_a.item())
    out["cached_update_cosine"] = cosine(pa - p0, pb - p0)
    out["cached_param_max_abs_diff"] = float((pa - pb).abs().max())
    print(f"  cached vs uncached on the card: loss {loss_b.item():.6f} vs "
          f"{loss_a.item():.6f} (rel diff {out['cached_loss_rel_diff']:.2e}, "
          f"gate <= 1e-3); update cosine {out['cached_update_cosine']:.6f} "
          f"(gate >= 0.99), updated parameters max abs diff "
          f"{out['cached_param_max_abs_diff']:.2e}", flush=True)
    require(out["cached_loss_rel_diff"] <= 1e-3,
            f"cached loss {out['cached_loss_rel_diff']}")
    require(out["cached_update_cosine"] >= 0.99,
            f"cached update {out['cached_update_cosine']}")
    return out


class MemoryStructTokens(StructTokenDataset):
    """The package's StructTokenDataset with its records in memory (the
    card's host has no h5py): ids from the split's id file, as the package
    reads them, strucseq strings from `records`."""

    def __init__(self, records: dict, **kwargs):
        super().__init__(**kwargs)
        self.records = records

    def read_strucseq(self, seq_id: str):
        return self.records.get(seq_id)


def struct_token_records(root: str, rng) -> dict:
    """TRAINER_PAIRS train and TRAINER_VAL_PAIRS val (and test) pairs:
    bench.py's log-normal residue lengths (median 290, sigma 0.65) clipped
    to [30, 1022], a random sequence and a 3Di string as long, interleaved
    as SaProt stores them; the split id files are written to `root`."""
    records = {}
    for split, n in (("train", TRAINER_PAIRS), ("val", TRAINER_VAL_PAIRS),
                     ("test", TRAINER_VAL_PAIRS)):
        ids = [f"{split}_{i:05d}" for i in range(n)]
        lens = np.clip(rng.lognormal(np.log(290.0), 0.65, n), 30, 1022)
        for sid, n_res in zip(ids, lens.astype(int)):
            aa = rng.choice(list(AAS), n_res)
            tdi = rng.choice(list(FOLDSEEK), n_res)
            records[sid] = "".join(a + b for a, b in zip(aa, tdi))
        with open(os.path.join(root, f"{split}_saprot.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return records


def struct_token_datamodule(root: str, records: dict, rows: int = ROWS,
                            val_batch: int = TRAINER_VAL_BATCH
                            ) -> OneProtDataModule:
    """configs/experiment/train_packed.yaml's data module (packed train
    rows of ROW_LEN tokens, SLOTS slots; the default buckets; the
    struct-token batch sizes) over the in-memory records."""
    return OneProtDataModule(
        modalities={"struct_token": {
            "dataset": {"data_dir": root, "filename": "", "max_length": 1024,
                        "records": records},
            "batch_size": {"train": 16, "val": val_batch, "test": 64}}},
        buckets=list(DATA_BUCKETS), pack_sequences=True, pack_rows=rows,
        pack_row_len=ROW_LEN, pack_slots=SLOTS,
        dataset_classes={"struct_token": MemoryStructTokens})


def trainer_module(hub, tower) -> OneProtModule:
    """bench.py's module at its Adam rate (CLIP + 0.01 L1, clipping at 1.0),
    with the reference's plateau scheduler on val/loss_best."""
    return OneProtModule({"sequence": hub, "struct_token": tower},
                         optimizer=lambda: adam(TRAINER_LR), loss_fn="CLIP",
                         use_l1_regularization=True,
                         scheduler={"monitor": "val/loss_best",
                                    "factor": 0.1, "patience": 10})


class TrainerProbe:
    """Reads the trainer's run from outside: each epoch's start (set_epoch)
    and each validation are marked with the launch counters, the cache's
    counts, the backbone forwards (`encode_pooled`, `encode_packed_pooled`:
    the hub's, and a frozen text tower's) and the clock; each training
    batch's wall ends at a synchronize after its step (so its host and
    device work do not overlap) and is split at the cache's lookups
    (`get_pooled_packed`, `get_pooled`) into the loader's share (from the
    last step's end), the lookups' and the step's; every step's loss is
    kept. Checkpoint writes are timed."""

    STEPS = ("train_step_packed_cached", "train_step_cached",
             "train_step_fully_cached", "train_step_packed", "train_step")
    LOOKUPS = ("get_pooled_packed", "get_pooled")

    def __init__(self, module, datamodule):
        self.marks, self.batch_ends, self.losses, self.saves = [], [], [], []
        self.pairs = []  # real pairs of each step
        self.step_modalities = []
        # step index -> [first lookup's start, last lookup's end]
        self.lookups = {}
        self.hub_forwards = 0
        self.encodes = {}  # backbone forwards by modality
        self.trainer = None
        self.in_val = False
        patch = lambda obj, name, wrap: setattr(obj, name, wrap(getattr(obj, name)))

        def count_hub(fn):
            def run(modality, *a, **k):
                self.hub_forwards += 1
                self.encodes[modality] = self.encodes.get(modality, 0) + 1
                return fn(modality, *a, **k)
            return run

        def step(fn, packed):
            def run(*a, **k):
                loss, n = fn(*a, **k)
                torch.cuda.synchronize()
                self.batch_ends.append(time.time())
                self.losses.append(loss)
                self.step_modalities.append(a[0])
                # the real pairs: a packed step's valid slots, else the
                # rows of its hub side (a graph tower's input is a dict)
                self.pairs.append(int(np.asarray(a[-1]).sum()) if packed
                                  else len(a[1]))
                return loss, n
            return run

        def set_epoch(fn):
            def run(epoch):
                self.mark("epoch", epoch)
                return fn(epoch)
            return run

        patch(module, "encode_packed_pooled", count_hub)
        patch(module, "encode_pooled", count_hub)
        for name in self.STEPS:
            patch(module, name,
                  lambda fn, packed=name.startswith("train_step_packed"):
                  step(fn, packed))
        patch(datamodule, "set_epoch", set_epoch)
        self._write = checkpoint_lib.CheckpointManager._write

        def timed_write(manager, name, *a, **k):
            t = time.time()
            path = self._write(manager, name, *a, **k)
            size = os.path.getsize(os.path.join(path, checkpoint_lib.STATE_FILE))
            self.saves.append({"name": name, "s": time.time() - t,
                               "gib": size / 2**30})
            return path

        checkpoint_lib.CheckpointManager._write = timed_write
        self._lookups = {name: getattr(FrozenFeatureCache, name)
                         for name in self.LOOKUPS}

        def timed(fn):
            def lookup(cache, *a, **k):
                t = time.time()
                out = fn(cache, *a, **k)
                if not self.in_val:
                    span = self.lookups.setdefault(len(self.batch_ends), [t, 0.0])
                    span[1] = time.time()
                return out
            return lookup

        for name, fn in self._lookups.items():
            setattr(FrozenFeatureCache, name, timed(fn))

    def close(self) -> None:
        checkpoint_lib.CheckpointManager._write = self._write
        for name, fn in self._lookups.items():
            setattr(FrozenFeatureCache, name, fn)

    def batch_split(self, s0: int, s1: int, t0: float):
        """(walls ms, median split ms) of steps s0..s1-1, the first batch
        starting at t0: the loader's share (from the last step's end to the
        first lookup), the lookups' and the step's (a step without a lookup
        has a lookup share of 0)."""
        ends = [t0] + self.batch_ends[s0:s1]
        parts = []
        for j, (start, end) in enumerate(zip(ends[:-1], ends[1:])):
            a, b = self.lookups.get(s0 + j, (start, start))
            parts.append((a - start, b - a, end - b))
        med = np.median(np.array(parts), axis=0) * 1e3
        return (np.diff(ends) * 1e3,
                {"loader": float(med[0]), "lookup": float(med[1]),
                 "step": float(med[2])})

    def mark(self, kind: str, epoch=None) -> None:
        torch.cuda.synchronize()
        cache = self.trainer._feature_cache if self.trainer else None
        self.marks.append({
            "kind": kind, "epoch": epoch, "t": time.time(),
            "launches": read_launches(), "hub_forwards": self.hub_forwards,
            "encodes": dict(self.encodes),
            "steps": len(self.batch_ends), "hits": cache.hits if cache else 0,
            "misses": cache.misses if cache else 0})

    def attach(self, trainer) -> None:
        """Mark the start and end of each of `trainer`'s validations."""
        self.trainer = trainer
        validate = trainer.validate

        def run(*a, **k):
            self.mark("val start")
            self.in_val = True
            try:
                out = validate(*a, **k)
            finally:
                self.in_val = False
            self.mark("val end")
            return out

        trainer.validate = run


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def epoch_rows(probe: TrainerProbe) -> list:
    """Per epoch of the probe's runs (its marks: epoch, val start, val end,
    epoch, ...): batches, pairs/s, the batch walls and their split, the
    cache's hit rates, the validation's wall and the launches of both.
    Gated: the launches of each epoch and of its validation (33 #1 a hub
    forward, 12 each of #1, #2, #3 a tower step, 12 #1 a validation batch),
    the hub forwards and the misses. Epoch 1 and its validation take every
    protein from the cache; the others start from a fresh one."""
    marks, epochs = probe.marks, []
    none = {name: 0 for name in LAUNCHERS}
    for i, m in enumerate(marks):
        if m["kind"] != "epoch":
            continue
        v0, v1 = marks[i + 1], marks[i + 2]
        require(v0["kind"] == "val start" and v1["kind"] == "val end",
                f"epoch {m['epoch']}: marks {marks[i:i + 3]}")
        nb = v0["steps"] - m["steps"]
        hub_train = v0["hub_forwards"] - m["hub_forwards"]
        hub_val = v1["hub_forwards"] - v0["hub_forwards"]
        n_val = TRAINER_VAL_PAIRS // TRAINER_VAL_BATCH
        train_l, val_l = delta(m["launches"], v0["launches"]), delta(
            v0["launches"], v1["launches"])
        want_train = {**none, "flash_mha_fwd": N_LAYERS * hub_train
                      + TOWER_LAYERS * nb, "flash_mha_bwd_dq": TOWER_LAYERS * nb,
                      "flash_mha_bwd_dkv": TOWER_LAYERS * nb}
        want_val = {**none, "flash_mha_fwd": N_LAYERS * hub_val
                    + TOWER_LAYERS * n_val}
        require(train_l == want_train, f"epoch {m['epoch']} launches {train_l}, "
                f"want {want_train}")
        require(val_l == want_val, f"validation {m['epoch']} launches {val_l}, "
                f"want {want_val}")
        # a fresh cache (epochs 0 and 2: the resumed run's is new) misses
        # on every protein; epoch 1 and its validation hit on every one
        cold = m["epoch"] != 1
        require(hub_train == (nb if cold else 0) and hub_val == (
            n_val if cold else 0), f"epoch {m['epoch']}: hub forwards "
            f"{hub_train} train, {hub_val} val over {nb} and {n_val} batches")
        # each run's trainer builds its own cache: counts start at 0
        hits, misses = v0["hits"] - m["hits"], v0["misses"] - m["misses"]
        vh, vm = v1["hits"] - v0["hits"], v1["misses"] - v0["misses"]
        require((misses, vm) == ((TRAINER_PAIRS, TRAINER_VAL_PAIRS) if cold
                                 else (0, 0)),
                f"epoch {m['epoch']}: {misses} train and {vm} val misses")
        walls, split = probe.batch_split(m["steps"], v0["steps"], m["t"])
        train_s = v0["t"] - m["t"]
        epochs.append({
            "epoch": m["epoch"], "batches": nb,
            "pairs_per_s": TRAINER_PAIRS / train_s, "train_s": train_s,
            "median_batch_ms": float(np.median(walls)),
            "batch_ms": [float(x) for x in walls],
            "median_split_ms": split,
            "cache_hit_rate": hits / max(hits + misses, 1),
            "val_cache_hit_rate": vh / max(vh + vm, 1),
            "val_s": v1["t"] - v0["t"], "launches": train_l,
            "val_launches": val_l})
    return epochs


def trainer_phase(smi: str, launches: dict, cached_step_ms: float):
    """Trainer.fit at full width: 2 epochs, then a resume from last for a
    third; fills `launches`. Returns (numbers, (the hub's and the tower's
    first 2 layers before training, their configs), the records)."""
    hub = create_sequence_encoder(proj_type="mlp")
    esm2.init_esm2_weights_(hub, torch.Generator(device="cuda").manual_seed(9))
    tower = create_struct_token_encoder()
    esm2.init_esm2_weights_(tower, torch.Generator(device="cuda").manual_seed(10))
    require((hub.config.num_layers, tower.config.num_layers)
            == (N_LAYERS, TOWER_LAYERS), "trainer model depths")
    initial = (first_layers(hub.state_dict(), 2),
               first_layers(tower.state_dict(), 2), hub.config, tower.config)
    module = trainer_module(hub, tower)
    out, result = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as root:
        records = struct_token_records(root, np.random.RandomState(TRAINER_SEED))
        dm = struct_token_datamodule(root, records)
        probe = TrainerProbe(module, dm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            for run, epochs, ckpt in (("fit", 2, None),
                                      ("resume", 3, "checkpoints/last")):
                trainer = Trainer(max_epochs=epochs, accelerator="gpu",
                                  cache_frozen_features=True,
                                  log_every_n_steps=TRAINER_LOG_EVERY,
                                  default_root_dir=root)
                probe.attach(trainer)
                t = time.time()
                out[run] = trainer.fit(
                    module, dm, ckpt_path=ckpt and os.path.join(root, ckpt))
                probe.mark("end")
                out[run + "_s"] = time.time() - t
                out[run + "_step"] = module.step
                with open(os.path.join(root, "checkpoints",
                                       "last.metrics.json")) as f:
                    out[run + "_sidecar_epoch"] = json.load(f)["trainer/epoch"]
        finally:
            probe.close()
        launches["trainer"] = read_launches()
    require(not any(PLAIN_CALLS.values()),
            f"trainer: plain versions ran on the card: {PLAIN_CALLS}")
    losses = torch.stack(probe.losses).float().cpu().numpy()
    require(bool(np.isfinite(losses).all()), f"non-finite trainer loss {losses}")

    epochs = epoch_rows(probe)
    require([e["epoch"] for e in epochs] == [0, 1, 2],
            f"epochs run: {[e['epoch'] for e in epochs]}")
    require(out["fit_sidecar_epoch"] == 1 and out["resume_sidecar_epoch"] == 2,
            f"sidecar epochs {out['fit_sidecar_epoch']}, "
            f"{out['resume_sidecar_epoch']}")
    steps = [e["batches"] for e in epochs]
    require(out["fit_step"] == steps[0] + steps[1]
            and out["resume_step"] == sum(steps),
            f"steps {out['fit_step']}, {out['resume_step']} over batches {steps}")
    require(out["resume"]["train/steps"] == out["resume_step"],
            "resumed train/steps")
    # the plateau scheduler on a scripted metric that does not improve:
    # patience 0 multiplies the rate by its factor once
    lr0 = get_learning_rate(module.opt)
    plateau = ReduceLROnPlateau(monitor="val/loss", patience=0, factor=0.5)
    plateau.on_validation_end(module, {"val/loss": 1.0})
    reduced = plateau.on_validation_end(module, {"val/loss": 1.0})
    lr1 = get_learning_rate(module.opt)
    require(reduced == lr1 == lr0 * 0.5, f"plateau: lr {lr0} -> {lr1}")
    result = {
        "pairs": {"train": TRAINER_PAIRS, "val": TRAINER_VAL_PAIRS},
        "epochs": epochs, "fit_s": out["fit_s"], "resume_s": out["resume_s"],
        "steps": {"fit": out["fit_step"], "resume": out["resume_step"]},
        "bare_cached_step_ms": cached_step_ms,
        "saves": probe.saves, "lr": [lr0, lr1],
        "val": {k: out[run][k] for run in ("fit",) for k in out[run]
                if k.startswith("val/")},
        "resumed_val_loss": out["resume"]["val/loss"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    for e in epochs:
        print(f"  epoch {e['epoch']}: {e['batches']} packed batches, "
              f"{e['pairs_per_s']:.1f} pairs/s ({e['train_s']:.2f} s), median "
              f"batch {e['median_batch_ms']:.1f} ms against the bare cached "
              f"step's {cached_step_ms:.1f} ms (medians: loader "
              f"{e['median_split_ms']['loader']:.1f}, cache lookup "
              f"{e['median_split_ms']['lookup']:.1f}, step "
              f"{e['median_split_ms']['step']:.1f} ms); cache hit rate "
              f"{e['cache_hit_rate']:.3f} train, {e['val_cache_hit_rate']:.3f} "
              f"val; validation {e['val_s']:.2f} s; launches {e['launches']}; "
              f"validation {e['val_launches']}", flush=True)
    val = result["val"]
    print(f"  val/loss {val['val/loss']:.4f} (resumed run "
          f"{result['resumed_val_loss']:.4f}); seq->mod R@1 "
          f"{val['val/seq_to_mod_R@1/val_struct_token']:.4f} R@10 "
          f"{val['val/seq_to_mod_R@10/val_struct_token']:.4f} median rank "
          f"{val['val/seq_to_mod_median_rank/val_struct_token']:.0f}; mod->seq "
          f"R@1 {val['val/mod_to_seq_R@1/val_struct_token']:.4f} R@10 "
          f"{val['val/mod_to_seq_R@10/val_struct_token']:.4f} median rank "
          f"{val['val/mod_to_seq_median_rank/val_struct_token']:.0f}", flush=True)
    print("  checkpoint saves: " + ", ".join(
        f"{s['name']} {s['s']:.2f} s {s['gib']:.2f} GiB" for s in probe.saves)
        + f"; steps {out['fit_step']} then {out['resume_step']} after the "
        f"resume; plateau lr {lr0:g} -> {lr1:g}; peak "
        f"{result['peak_gib']:.2f} GiB; {smi}", flush=True)
    return result, initial, records


def trainer_parity(initial, records: dict, lr: float = TRAINER_LR) -> dict:
    """Trainer.fit (packed + cache) at 2 hub + 2 tower layers from the
    same weights, TRAINER_PARITY_ROWS rows a batch, 2 batches an epoch, 2 epochs,
    Adam at `lr` (bench.py's 1e-3, and 1e-4 beside it): card (bf16,
    kernels) against CPU (f32, plain versions), loss by loss and on the
    final trainable parameters."""
    hub_state, tower_state, hub_cfg, tower_cfg = initial
    state = {**{"encoders.sequence." + k: v for k, v in hub_state.items()},
             **{"encoders.struct_token." + k: v for k, v in tower_state.items()}}
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_parity_") as root:
        # the trainer phase's records; PARITY_TRAIN_PAIRS of them to train
        # on (two batches of TRAINER_PARITY_ROWS rows), so epoch 2 hits the
        # cache
        ids = {s: sorted(k for k in records if k.startswith(s + "_"))
               for s in ("train", "val", "test")}
        ids["train"] = ids["train"][:PARITY_TRAIN_PAIRS]
        for split, keys in ids.items():
            with open(os.path.join(root, f"{split}_saprot.txt"), "w") as f:
                f.write("\n".join(keys) + "\n")
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            module = OneProtModule(
                {"sequence": SequenceEncoder(
                    dataclasses.replace(hub_cfg, num_layers=2), 1024,
                    proj_type="mlp", device=device, dtype=dtype),
                 "struct_token": StructTokenEncoder(
                     dataclasses.replace(tower_cfg, num_layers=2), 1024,
                     device=device, dtype=dtype)},
                optimizer=lambda: adam(lr), loss_fn="CLIP",
                use_l1_regularization=True)
            module.model.load_state_dict(state)
            run_dir = os.path.join(root, device)
            trainer = Trainer(max_epochs=2, accelerator="gpu" if device == "cuda"
                              else "cpu", limit_train_batches=2,
                              check_val_every_n_epoch=3, log_every_n_steps=1,
                              default_root_dir=run_dir)
            trainer.fit(module, struct_token_datamodule(root, records,
                                                        rows=TRAINER_PARITY_ROWS))
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                losses = [json.loads(line)["train/loss_struct_token"]
                          for line in f if "train/loss_struct_token" in line]
            runs[device] = {"losses": losses, "params": flat(module.opt.params),
                            "hits": trainer._feature_cache.hits}
    card, cpu = runs["cuda"], runs["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"])]
    out = {"loss_card": card["losses"], "loss_cpu": cpu["losses"],
           "loss_rel_diff": rel, "lr": lr, "margin": 2e-2 - max(rel),
           "param_cosine": cosine(card["params"], cpu["params"]),
           "cache_hits": [card["hits"], cpu["hits"]]}
    print(f"  trainer, 4 steps at Adam {lr:g}, card vs CPU: losses "
          + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(card["losses"],
                                                          cpu["losses"]))
          + f" (rel diff max {max(rel):.2e}, gate <= 2e-2 each: margin "
          f"{out['margin']:.2e}); final "
          f"trainable parameters' cosine {out['param_cosine']:.6f} (gate >= "
          f"0.99); cache hits {out['cache_hits']}", flush=True)
    require(len(card["losses"]) == len(cpu["losses"]) == TRAINER_PARITY_STEPS,
            f"trainer parity steps {len(card['losses'])}, {len(cpu['losses'])}")
    require(card["hits"] == cpu["hits"], "trainer parity cache hits differ")
    require(max(rel) <= 2e-2, f"trainer loss parity {rel}")
    require(out["param_cosine"] >= 0.99, f"trainer parameter parity {out}")
    return out


class CliDataModule(OneProtDataModule):
    """The data module the configs name, with the HDF5 modalities served
    from RECORDS in memory (the card's host has no h5py): RECORDS maps a
    modality to its records, which its dataset config gains; the
    struct-token, text, struct_graph and pocket datasets are
    MemoryStructTokens, MemoryTexts and MemoryStructs (the data module
    ignores a dataset's `_target_`, as the JAX package's does). MSA and
    seqsim read their files. The CLI phases alias the configs'
    data-module target to it."""

    RECORDS: dict = {}

    def __init__(self, modalities, **kwargs):
        memory = {"struct_token": MemoryStructTokens, "text": MemoryTexts,
                  "struct_graph": MemoryStructs, "pocket": MemoryStructs}
        modalities = {
            name: ({**cfg, "dataset": {**cfg["dataset"],
                                       "records": self.RECORDS[name]}}
                   if name in self.RECORDS else cfg)
            for name, cfg in modalities.items()}
        super().__init__(modalities, dataset_classes={
            name: cls for name, cls in memory.items() if name in self.RECORDS},
            **kwargs)


class CliProbe:
    """Reads `cli.train.main` runs from outside: each run's model build
    (timed to a synchronize), its Trainer.fit (through a TrainerProbe) and
    its Trainer.test (wall and launches), one dict per run in `runs`."""

    def __init__(self):
        self.runs = []
        self.saved = (cli_train.build_model, Trainer.fit, Trainer.test)
        build0, fit0, test0 = self.saved

        def build(*a, **k):
            t = time.time()
            module = build0(*a, **k)
            torch.cuda.synchronize()
            self.runs[-1]["build_s"] = time.time() - t
            return module

        def fit(trainer, module, datamodule, **k):
            probe = TrainerProbe(module, datamodule)
            probe.attach(trainer)
            self.runs[-1].update(module=module, datamodule=datamodule,
                                 probe=probe)
            t = time.time()
            try:
                return fit0(trainer, module, datamodule, **k)
            finally:
                probe.mark("end")
                probe.close()
                self.runs[-1]["fit_s"] = time.time() - t

        def test(trainer, module, datamodule):
            torch.cuda.synchronize()
            t, before = time.time(), read_launches()
            metrics = test0(trainer, module, datamodule)
            torch.cuda.synchronize()
            self.runs[-1].update(test_s=time.time() - t,
                                 test_launches=delta(before, read_launches()))
            return metrics

        cli_train.build_model, Trainer.fit, Trainer.test = build, fit, test

    def main(self, argv: list):
        self.runs.append({})
        t = time.time()
        metrics = cli_train.main(argv)
        self.runs[-1]["main_s"] = time.time() - t
        return metrics

    def close(self) -> None:
        cli_train.build_model, Trainer.fit, Trainer.test = self.saved


def cli_phase(smi: str, launches: dict) -> dict:
    """configs/experiment/train_packed.yaml through `cli.train.main`, in
    process, at bench.py's widths in bf16 (as shipped, in f32, it is
    `f32_experiments_phase`'s): 2 epochs and the test split, then a
    test-only run from the first run's `last`. Fills launches["cli"]."""
    none = {name: 0 for name in LAUNCHERS}
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        CliDataModule.RECORDS = {"struct_token": struct_token_records(
            root, np.random.RandomState(TRAINER_SEED))}
        register_target_alias(CLI_DATA_TARGET, f"{__name__}.CliDataModule")
        base = list(CLI_BASE) + [f"paths.data_dir={root}"]
        run_dir = os.path.join(root, "run")
        argv = base + list(CLI_MODEL) + ["trainer.max_epochs=2", "test=true",
                                         f"hydra.run.dir={run_dir}"]
        last = os.path.join(run_dir, "checkpoints", "last")
        probe = CliProbe()
        try:
            t = time.time()
            load_config(default_config_dir(), "train", argv)
            out["compose_ms"] = (time.time() - t) * 1e3
            torch.cuda.synchronize()
            reset_launches()
            fit_metrics = probe.main(argv)
            test_metrics = probe.main(
                base + list(CLI_MODEL) + ["train=false", "test=true",
                                          f"ckpt_path={last}",
                                          f"hydra.run.dir={root}/test_only"])
            launches["cli"] = read_launches()
            plain = dict(PLAIN_CALLS)
            files = {name: os.path.exists(os.path.join(run_dir, name)) for name in (
                "resolved_config.json", "resolved_config.yaml", "metrics.jsonl",
                "checkpoints/last", "checkpoints/best")}
            # the first run's module at `last`, tested without a cache
            first = probe.runs[0]
            checkpoint_lib.load_state(first["module"], last)
            reference = Trainer(
                accelerator="gpu", default_root_dir=os.path.join(root, "ref")
            ).validate(first["module"], first["datamodule"], split="test")
        finally:
            probe.close()
            TARGET_ALIASES.pop(CLI_DATA_TARGET, None)
            CliDataModule.RECORDS = {}
        out["struct_tokens"] = serve_struct_tokens(run_dir, launches)
        out["_rows"] = logged_rows(run_dir)
    first, second = probe.runs
    require(not any(plain.values()), f"cli: plain versions ran on the card: "
            f"{plain}")
    epochs = epoch_rows(first["probe"])
    require([e["epoch"] for e in epochs] == [0, 1], f"cli epochs {epochs}")
    require(epochs[1]["cache_hit_rate"] == epochs[1]["val_cache_hit_rate"]
            == 1.0, "cli epoch 2 cache hits")
    require(first["module"].step == sum(e["batches"] for e in epochs)
            == fit_metrics["train/steps"], "cli steps")
    n_test = -(-TRAINER_VAL_PAIRS // CLI_TEST_BATCH)
    want_test = {**none, "flash_mha_fwd": (N_LAYERS + TOWER_LAYERS) * n_test}
    for run in (first, second):
        require(run["test_launches"] == want_test, f"cli test launches "
                f"{run['test_launches']}, want {want_test}")
    total = {k: sum(e["launches"][k] + e["val_launches"][k] for e in epochs)
             + first["test_launches"][k] + second["test_launches"][k]
             for k in none}
    require(launches["cli"] == total, f"cli launches {launches['cli']}, want "
            f"{total}")
    finite = [v for k, v in {**fit_metrics, **test_metrics}.items()
              if k.startswith(("val/", "test/"))]
    require(len(finite) > 10 and bool(np.isfinite(finite).all()),
            f"cli metrics {fit_metrics} {test_metrics}")
    require(all(files.values()), f"cli run dir: {files}")
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("yaml", "h5py", "jax", "oneprot_tpu")]
    require(not loaded, f"cli: modules loaded {loaded}")
    tested = {k: v for k, v in test_metrics.items() if k.startswith("test/")}
    rel = max(abs(tested[k] - reference[k]) / max(abs(reference[k]), 1e-12)
              for k in reference)
    require(sorted(tested) == sorted(reference) and rel <= 1e-5,
            f"test-only run {tested} against last {reference}")
    out.update({
        "pairs": {"train": TRAINER_PAIRS, "val": TRAINER_VAL_PAIRS,
                  "test": TRAINER_VAL_PAIRS},
        "model_build_s": first["build_s"], "fit_s": first["fit_s"],
        "epochs": [{k: e[k] for k in ("epoch", "batches", "pairs_per_s",
                                      "train_s", "median_batch_ms",
                                      "median_split_ms", "cache_hit_rate",
                                      "val_cache_hit_rate", "val_s")}
                   for e in epochs],
        "test_s": first["test_s"], "main_s": first["main_s"],
        "checkpoint_saves": first["probe"].saves,
        "test_only": {"model_build_s": second["build_s"],
                      "test_s": second["test_s"], "main_s": second["main_s"],
                      "max_rel_diff_vs_last": rel},
        "val_loss": fit_metrics["val/loss"], "test_loss": test_metrics["test/loss"],
        "launches": launches["cli"]})
    print("  cli: compose {:.1f} ms, model build {:.2f} s, fit {:.2f} s ({}), "
          "test {:.2f} s, checkpoints {}; test-only run: build {:.2f} s, test "
          "{:.2f} s, max rel diff against last {:.1e}; val/loss {:.4f}, "
          "test/loss {:.4f}; launches {}; {}".format(
              out["compose_ms"], first["build_s"], first["fit_s"],
              ", ".join(f"epoch {e['epoch']}: {e['batches']} batches, "
                        f"{e['pairs_per_s']:.1f} pairs/s, hit rate "
                        f"{e['cache_hit_rate']:.3f}" for e in epochs),
              first["test_s"], ", ".join(
                  f"{s['name']} {s['s']:.2f} s" for s in first["probe"].saves),
              second["build_s"], second["test_s"], rel, out["val_loss"],
              out["test_loss"], launches["cli"], smi),
          flush=True)
    return out


def logged_rows(run_dir: str) -> list:
    """A run dir's metrics rows without their wall-clock time and without
    the test split's row."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [{k: v for k, v in r.items() if k != "time"} for r in rows
            if not any(k.startswith("test/") for k in r)]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_children(commands: list, timeout: float) -> list:
    """Start every (argv, env) at once; wait for all under `timeout`
    seconds, killing every one still running when it passes or when this
    process fails. Returns each one's (exit code, output)."""
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv, env in commands]
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            try:
                outs.append((p.wait(timeout=max(deadline - time.time(), 1)),
                             p.stdout.read()))
            except subprocess.TimeoutExpired:
                outs.append((None, "timed out"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def child_env(**extra) -> dict:
    """This process's environment without a launcher's variables, plus
    `extra`."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT", "ONEPROT_NUM_PROCESSES")}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def cli_child(mode: str, root: str, run_dir: str) -> int:
    """The CLI phase's first run (train_packed, bf16, full width, 2 epochs,
    no test split) in this process: `mode` "single", or "ddp" with
    `trainer=ddp` in the torchrun environment the parent gave, under
    torch's deterministic algorithms (the tower's embedding backward, a
    torch op, adds with atomics otherwise: scripts/probe_determinism.py;
    the port's kernels are deterministic either way). Writes the launches,
    the plain calls and the process group to run_dir/child.json."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    count_plain_calls()
    CliDataModule.RECORDS = {"struct_token": struct_token_records(
        root, np.random.RandomState(TRAINER_SEED))}
    register_target_alias(CLI_DATA_TARGET, f"{__name__}.CliDataModule")
    base = [("trainer=ddp" if mode == "ddp" and a == "trainer=gpu" else a)
            for a in CLI_BASE]
    argv = base + list(CLI_MODEL) + [f"paths.data_dir={root}",
                                     "trainer.max_epochs=2", "test=false",
                                     f"hydra.run.dir={run_dir}"]
    reset_launches()
    cli_train.main(argv)
    torch.cuda.synchronize()
    group = ({"backend": dist.get_backend(), "world": dist.get_world_size()}
             if dist.is_initialized() else None)
    with open(os.path.join(run_dir, "child.json"), "w") as f:
        json.dump({"launches": read_launches(), "plain": PLAIN_CALLS,
                   "group": group}, f)
    shutdown_distributed()
    return 0


def row_diffs(a: list, b: list) -> dict:
    """{key: (largest relative difference, a's value, b's value)} over two
    runs' logged rows, for the keys that differ."""
    require([sorted(r) for r in a] == [sorted(r) for r in b],
            "the runs logged different rows")
    out = {}
    for x, y in zip(a, b):
        for k in y:
            if x[k] != y[k]:
                rel = abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                if rel > out.get(k, (0.0,))[0]:
                    out[k] = (rel, x[k], y[k])
    return out


def ddp_world_of_one_phase(smi: str, launches: dict, cli_rows: list) -> dict:
    """Phase (a): the CLI phase's run in three children at once (torch's
    deterministic algorithms on), two alone and one in a torchrun world of
    one over NCCL; the two single runs say whether the run is reproducible
    bit for bit, and the NCCL run must equal the first exactly, or lie
    within the single runs' spread, key by key. The in-process run (the
    default algorithms) is compared too, printed. Fills
    launches["ddp world of 1"]."""
    out = {}
    modes = ("single", "single again", "ddp")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as tmp:
        commands, dirs = [], {}
        for i, mode in enumerate(modes):
            root = os.path.join(tmp, str(i))
            os.makedirs(root)
            dirs[mode] = os.path.join(root, "run")
            # cuBLAS's reproducible workspace, as deterministic torch wants
            env = child_env(CUBLAS_WORKSPACE_CONFIG=":4096:8")
            if mode == "ddp":
                env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                           MASTER_PORT=str(free_port()))
            commands.append(([sys.executable, os.path.abspath(__file__),
                              "--cli-child", mode.split()[0], root,
                              dirs[mode]], env))
        t = time.time()
        results = run_children(commands, DDP_TIMEOUT_S)
        out["children_s"] = time.time() - t
        for (rc, log), mode in zip(results, modes):
            require(rc == 0, f"ddp phase: the {mode} child failed ({rc}):\n"
                    + log[-6000:])
        rows, child = {}, {}
        for mode, run_dir in dirs.items():
            rows[mode] = logged_rows(run_dir)
            with open(os.path.join(run_dir, "child.json")) as f:
                child[mode] = json.load(f)
        files = [os.path.exists(os.path.join(dirs["ddp"], name)) for name in (
            "resolved_config.yaml", "metrics.jsonl", "checkpoints/last",
            "checkpoints/best")]
    require(child["ddp"]["group"] == {"backend": "nccl", "world": 1},
            f"ddp child's process group {child['ddp']['group']}")
    require(child["single"]["group"] is None, "the single child made a group")
    require(all(files), f"ddp run dir: {files}")
    for mode in modes:
        require(not any(child[mode]["plain"].values()),
                f"ddp phase {mode}: plain versions ran: {child[mode]['plain']}")
        require(child[mode]["launches"] == child["single"]["launches"]
                and child[mode]["launches"]["flash_mha_bwd_dq"] > 0,
                f"ddp phase {mode} launches {child[mode]['launches']}")
    launches["ddp world of 1"] = child["ddp"]["launches"]
    spread = row_diffs(rows["single again"], rows["single"])
    got = row_diffs(rows["ddp"], rows["single"])
    out.update(rows=len(cli_rows), reproducible=not spread,
               single_spread={k: v[0] for k, v in spread.items()},
               ddp_vs_single={k: v[0] for k, v in got.items()},
               in_process_vs_single={
                   k: v[0] for k, v in row_diffs(cli_rows,
                                                 rows["single"]).items()})
    beyond = {k: v for k, v in got.items()
              if v[0] > spread.get(k, (0.0,))[0]}
    print(f"  three children at once in {out['children_s']:.1f} s, "
          f"{len(cli_rows)} logged rows each (train losses, val metrics, "
          f"cache stats): two single-process runs "
          + ("agree bit for bit" if not spread else
             "differ at " + ", ".join(f"{k} {v[1]} / {v[2]} (rel {v[0]:.2e})"
                                      for k, v in spread.items()))
          + "; the NCCL world of 1 (torchrun env, trainer=ddp) against the "
          "first: " + ("bit for bit" if not got else ", ".join(
              f"{k} {v[1]} / {v[2]} (rel {v[0]:.2e})" for k, v in got.items()))
          + f"; the in-process run against it: {out['in_process_vs_single']}"
          f"; launches {launches['ddp world of 1']}; {smi}", flush=True)
    require(not beyond, f"NCCL world of 1 beyond the single runs' spread: "
            f"{beyond}")
    return out


def gloo_setup():
    """Phase (b)'s model (the 650M hub with its mlp head and the 35M tower,
    from their seeds, CLIP + L1, Adam at SMOKE_LR) and its two packed
    batches of ROWS rows."""
    hub = create_sequence_encoder(proj_type="mlp")
    esm2.init_esm2_weights_(hub, torch.Generator(device="cuda").manual_seed(
        GLOO_HUB_SEED))
    tower = create_struct_token_encoder()
    esm2.init_esm2_weights_(tower, torch.Generator(device="cuda").manual_seed(
        GLOO_TOWER_SEED))
    rng = np.random.RandomState(GLOO_SEED)
    return build_module(hub, tower), [make_packed_batch(rng) for _ in range(2)]


def rows_of(batch: dict, rows: slice) -> dict:
    return {"seq": {k: v[rows] for k, v in batch["seq"].items()},
            "mod": {k: v[rows] for k, v in batch["mod"].items()},
            "valid": batch["valid"][rows]}


def gloo_steps(module: OneProtModule, batches: list):
    """GLOO_PACKED packed, GLOO_CACHED cached and GLOO_SIGLIP cached
    SigLIP steps, the batches in turn; returns (losses, step seconds)."""
    losses, secs = [], []

    def step(fn, *args):
        t = time.time()
        loss, _ = fn("struct_token", *args)
        losses.append(loss.item())
        secs.append(time.time() - t)

    for i in range(GLOO_PACKED):
        b = batches[i % 2]
        step(module.train_step_packed, b["seq"], b["mod"], b["valid"])
    pooled = [module.encode_packed_pooled("sequence", b["seq"]["ids"],
                                          b["seq"]["segment_ids"], SLOTS)
              for b in batches]
    for i in range(GLOO_CACHED + GLOO_SIGLIP):
        if i == GLOO_CACHED:
            module.loss_name = "SIGLIP"
        b = batches[i % 2]
        step(module.train_step_packed_cached, pooled[i % 2], b["mod"],
             b["valid"])
    return losses, secs


def gloo_launches() -> dict:
    """#1-#3 per rank over gloo_steps: a packed step runs the hub and the
    tower forward and the tower backward, the two pooled encodes the hub,
    a cached step the tower both ways."""
    steps, cached = GLOO_PACKED + GLOO_CACHED + GLOO_SIGLIP, \
        GLOO_CACHED + GLOO_SIGLIP
    return {**{name: 0 for name in LAUNCHERS},
            "flash_mha_fwd": GLOO_PACKED * (N_LAYERS + TOWER_LAYERS)
            + 2 * N_LAYERS + cached * TOWER_LAYERS,
            "flash_mha_bwd_dq": steps * TOWER_LAYERS,
            "flash_mha_bwd_dkv": steps * TOWER_LAYERS}


def trainable_state(module: OneProtModule) -> dict:
    return {n: p.detach().cpu().clone() for n, p in
            module.model.named_parameters() if p.requires_grad}


def local_only_gather(x: torch.Tensor) -> torch.Tensor:
    """Phase (b)'s control fault: the CLIP gather's forward, with a
    backward that keeps only this rank's own loss's gradient of its rows
    (the other ranks' part is dropped: no all-reduce)."""
    rank, b = world()[1], x.shape[0]
    full = all_gather_with_grad(x.detach())
    return torch.cat([full[:rank * b], x, full[(rank + 1) * b:]])


def gloo_child(rank: int, tmp: str) -> int:
    """One rank of phase (b): its half of the rows through gloo_steps;
    writes its losses, step and all-reduce times, launches and final
    trainable parameters to `tmp`. Then the control: the same steps from
    the same weights with the CLIP gather's backward made local-only
    (`local_only_gather`), whose final parameters the gate must refuse."""
    count_plain_calls()
    init_distributed(f"file://{tmp}/rendezvous", num_processes=GLOO_WORLD,
                     process_id=rank, backend="gloo", timeout_s=DDP_TIMEOUT_S)
    module, batches = gloo_setup()
    half = ROWS // GLOO_WORLD
    mine = [rows_of(b, slice(rank * half, (rank + 1) * half)) for b in batches]
    torch.cuda.synchronize()
    reset_launches()
    losses, secs = gloo_steps(module, mine)
    torch.cuda.synchronize()
    counts, plain = read_launches(), dict(PLAIN_CALLS)
    grads = [p.grad for p in module.opt.params]
    reduce_ms = []
    for _ in range(3):  # the gradient all-reduce alone, as the step makes it
        torch.cuda.synchronize()
        t = time.time()
        all_reduce_mean_(grads)
        torch.cuda.synchronize()
        reduce_ms.append((time.time() - t) * 1e3)
    torch.save(trainable_state(module), os.path.join(tmp, f"params{rank}.pt"))
    grad_numel = sum(g.numel() for g in grads)
    del module, grads
    torch.cuda.empty_cache()
    clip_lib.all_gather_with_grad = local_only_gather
    module, _ = gloo_setup()
    control_losses, _ = gloo_steps(module, mine)
    torch.save(trainable_state(module), os.path.join(tmp, f"control{rank}.pt"))
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "control_losses": control_losses,
                   "step_ms": [x * 1e3 for x in secs],
                   "allreduce_ms": reduce_ms, "launches": counts,
                   "plain": plain, "pairs": int(sum(b["valid"].sum()
                                                    for b in mine)),
                   "grad_numel": grad_numel}, f)
    shutdown_distributed()
    return 0


def ring_siglip_one_process(mod, seq, valid, axis_name=None):
    """The W = GLOO_WORLD ring's SigLIP in one process: each block of rows
    against its own columns (positives) and every other block's
    (negatives), normalised by its own valid rows, then the mean over the
    blocks, as each rank computes it and as the JAX module's shard_map
    does."""
    n = mod.shape[0] // GLOO_WORLD
    blocks = [slice(r * n, (r + 1) * n) for r in range(GLOO_WORLD)]
    total = 0.0
    for r in blocks:
        for c in blocks:
            total = total + siglip_lib._pair_loss_masked(
                mod[r], seq[c], valid[r], valid[c], 1.0, None,
                negative_only=c != r)
    return total / GLOO_WORLD


def gloo_two_ranks_phase(smi: str, launches: dict) -> dict:
    """Phase (b): the steps in this process on the whole rows, then two
    gloo ranks on their halves; fills launches["gloo rank 0"], ["gloo rank
    1"]."""
    module, batches = gloo_setup()
    start = trainable_state(module)
    module_lib.siglip_loss_masked = ring_siglip_one_process
    try:
        want, want_secs = gloo_steps(module, batches)
    finally:
        module_lib.siglip_loss_masked = siglip_lib.siglip_loss_masked
    want_params = trainable_state(module)
    del module
    torch.cuda.empty_cache()
    out = {"one_process_losses": want,
           "one_process_step_ms": [x * 1e3 for x in want_secs]}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        t = time.time()
        results = run_children(
            [([sys.executable, os.path.abspath(__file__), "--gloo-child",
               str(rank), tmp], child_env()) for rank in range(GLOO_WORLD)],
            DDP_TIMEOUT_S)
        out["children_s"] = time.time() - t
        for rank, (rc, log) in enumerate(results):
            require(rc == 0, f"gloo rank {rank} failed ({rc}):\n" + log[-6000:])
        ranks, params = [], []
        for rank in range(GLOO_WORLD):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
            params.append(torch.load(os.path.join(tmp, f"params{rank}.pt"),
                                     weights_only=True))
        control = torch.load(os.path.join(tmp, "control0.pt"),
                             weights_only=True)
    want_counts = gloo_launches()
    for rank, r in enumerate(ranks):
        launches[f"gloo rank {rank}"] = r["launches"]
        require(r["launches"] == want_counts, f"gloo rank {rank} launches "
                f"{r['launches']}, want {want_counts}")
        require(not any(r["plain"].values()),
                f"gloo rank {rank}: plain versions ran: {r['plain']}")
    require(ranks[0]["losses"] == ranks[1]["losses"],
            "the ranks report different losses")
    got = np.array(ranks[0]["losses"])
    rel = np.abs(got - want) / np.abs(want)
    same = all(torch.equal(params[0][n], params[1][n]) for n in params[0])

    def change(state):  # what the steps did to the seeded weights
        return flat(state[n] - start[n] for n in start)

    want_change = change(want_params)
    cos = cosine(change(params[0]), want_change)
    control_cos = cosine(change(control), want_change)
    control_losses = np.array(ranks[0]["control_losses"])
    control_rel = float(np.max(np.abs(control_losses - want) / np.abs(want)))
    out.update({
        "losses": got.tolist(), "loss_rel": rel.tolist(),
        "loss_margin": GLOO_LOSS_REL - float(rel.max()),
        "change_cosine": cos, "control_change_cosine": control_cos,
        "control_losses": control_losses.tolist(),
        "control_loss_rel": control_rel, "ranks_bit_identical": same,
        "pairs": [r["pairs"] for r in ranks],
        "step_ms": [r["step_ms"] for r in ranks],
        "median_step_ms": [float(np.median(r["step_ms"])) for r in ranks],
        "allreduce_ms": [r["allreduce_ms"] for r in ranks],
        "allreduce_mb": ranks[0]["grad_numel"] * 4 / 2**20,
        "launches": want_counts})
    print(f"  gloo, 2 ranks on one card ({out['children_s']:.1f} s with "
          f"start-up and build): pairs per rank {out['pairs']}; losses "
          + ", ".join(f"{x:.4f}" for x in got) + f" against one process "
          + ", ".join(f"{x:.4f}" for x in want)
          + f"; max rel {rel.max():.2e} (gate {GLOO_LOSS_REL}, margin "
          f"{out['loss_margin']:.2e}); the trainable parameters' change "
          f"against one process's: cosine {cos:.6f} (gate >= "
          f"{GLOO_DELTA_COS}), the control with a local-only gather "
          f"backward {control_cos:.6f} (must fall below the gate; its "
          "losses " + ", ".join(f"{x:.4f}" for x in control_losses)
          + f", max rel {control_rel:.2e}); ranks bit-identical {same}; "
          "median step ms "
          + ", ".join(f"rank {i} {m:.1f}" for i, m in
                      enumerate(out["median_step_ms"]))
          + f" (one process on both halves {np.median(want_secs) * 1e3:.1f}); "
          f"gradient all-reduce ({out['allreduce_mb']:.1f} MiB f32, through "
          f"host memory) ms " + ", ".join(
              f"rank {i} " + "/".join(f"{x:.1f}" for x in r)
              for i, r in enumerate(out["allreduce_ms"]))
          + f"; launches per rank {want_counts}; {smi}", flush=True)
    require(float(rel.max()) <= GLOO_LOSS_REL, f"gloo losses {out}")
    require(cos >= GLOO_DELTA_COS, f"gloo parameter change cosine {cos}")
    require(control_cos < GLOO_DELTA_COS, "the gate passed the control, a "
            f"local-only gather backward: change cosine {control_cos}")
    require(same, "the ranks' parameters differ")
    return out


# ---------------------------------------------------------------------------
# tensor parallelism: the shipped train_3b_tp recipe's model axis, as gloo
# ranks on the one card (NCCL refuses a card twice)

TP_OFF_NOISE = tuple(
    f"model.components.{tower}.encoder.{key}={value}"
    for tower in ("struct_graph", "pocket")
    for key, value in (("dropout", 0.0), ("euler_noise", "false"),
                       ("data_augment_eachlayer", "false")))
# phase A: configs/experiment/train_3b_tp.yaml at mesh.model 2 over four
# ranks (data 2 x model 2), the ESM2-3B hub at full width and depth (36 x
# 2560, 40 heads: 20 a rank); cut: 4 packed rows of 512 a process (the
# recipe's 32), graph batches of 4 (16), 2 batches of one epoch, no
# validation or test; the graph towers' noise and dropout off, so that one
# process on both data ranks' rows computes the same function (their
# per-data-rank seeds are tests/test_torch_tensor_parallel.py's)
TP_A = ("experiment=train_3b_tp", "trainer=gpu", "extras.print_config=false",
        "data.pack_rows=4", "data.modalities.struct_graph.batch_size.train=4",
        "data.modalities.pocket.batch_size.train=4", "trainer.max_epochs=1",
        "trainer.limit_train_batches=2", "trainer.check_val_every_n_epoch=2",
        "test=false") + TP_OFF_NOISE
# phase B: configs/experiment/train_packed.yaml with data=struct_token_only
# at the CLI phase's widths (650M hub, trainable 35M tower: 20 heads of 24,
# 10 a rank) over two ranks (data 1 x model 2); cut: 4 packed rows of 1024
# (16), 3 batches and one validation batch, no test
TP_B = CLI_BASE + CLI_MODEL + (
    "data.pack_rows=4", "trainer.max_epochs=1",
    "trainer.limit_train_batches=3", "trainer.limit_val_batches=1",
    "test=false")
# B32: phase B with both towers in f32 (the f32 instances of #1-#3), where
# the model axis changes no rounding that Adam could amplify
# (scripts/tp_f32_check.py)
TP_B32 = tuple(a for a in TP_B if not a.endswith("dtype=bfloat16")) + (
    "model.components.sequence.dtype=float32",
    "model.components.struct_token.dtype=float32")
TP_PHASES = {"A": (TP_A, 4), "B": (TP_B, 2), "B32": (TP_B32, 2)}
# phase A's third run: the recipe with the int8 hub (held whole on every
# model rank, as the JAX rules place its int8 leaves), one batch
TP_A_INT8 = ("model.components.sequence.quantize=int8",
             "trainer.limit_train_batches=1")
TP_ITEMS = {"train": 64, "val": 8, "test": 8}  # phase A's synthetic ids
TP_LONGEST = 510
TP_SEED = 31
# the change cosine's limit lies between the clean bf16 readings (0.9944-
# 0.9949: bf16 rounding at other places than one process's, which Adam's
# near-sign first updates turn into flips of small elements; the same
# phase in f32 reads 1.000000, scripts/tp_f32_check.py) and the controls'
# (0.933, 0.610), all in PERF.md
TP_LOSS_REL, TP_DELTA_COS, TP_HUB_BYTES = 1e-2, 0.99, 0.55


def draw_biases(on: bool = True) -> None:
    """Random weights with biases N(0, 0.02) (a shard draws the full bias
    and keeps its block): the seeded init leaves them zero, under which a
    row-parallel bias added on every rank would change nothing."""
    from oneprot_tpu_torch.models.layers import draw_

    init = esm2.__dict__.setdefault("_init_dense", esm2.init_dense_)
    if not on:
        esm2.init_dense_ = bert.init_dense_ = init
        return

    def init_dense(mod, generator):
        init(mod, generator)
        if mod.bias is not None:
            draw_(mod.bias, lambda b: b.normal_(0.0, 0.02,
                                                generator=generator))

    esm2.init_dense_ = bert.init_dense_ = init_dense


class TpRecorder:
    """Reads a CLI run from outside: the module `cli.train.build_model`
    made (and its trainable state then), each step's (modality, batch),
    loss and wall (to a synchronize), the heads of each attention forward
    (`_FlashMHA.apply`) and the row-parallel all-reduces' walls."""

    def __init__(self, keep_batches: bool):
        from oneprot_tpu_torch.core import collectives

        self.keep_batches = keep_batches
        self.steps, self.losses, self.step_ms = [], [], []
        self.heads, self.reduce_ms = {}, []
        self.module = self.initial = None
        self.saved = (cli_train.build_model, Trainer._train_one,
                      flash_mha._FlashMHA.apply,
                      collectives._ReduceFromModelGroup.forward)
        build0, step0, apply0, reduce0 = self.saved

        def build(*a, **k):
            self.module = build0(*a, **k)
            return self.module

        def step(trainer, module, modality, batch):
            if self.initial is None:  # after init's broadcast
                self.initial = tp_trainable(module)
            torch.cuda.synchronize()
            t = time.time()
            loss = step0(trainer, module, modality, batch)
            self.losses.append(float(loss))
            self.step_ms.append((time.time() - t) * 1e3)
            self.steps.append((modality, batch if self.keep_batches else None))
            return loss

        def apply(q, k, v, num_heads, *rest):
            self.heads[num_heads] = self.heads.get(num_heads, 0) + 1
            return apply0(q, k, v, num_heads, *rest)

        def reduce(ctx, x):
            torch.cuda.synchronize()
            t = time.time()
            out = reduce0(ctx, x)
            self.reduce_ms.append((time.time() - t) * 1e3)
            return out

        cli_train.build_model, Trainer._train_one = build, step
        flash_mha._FlashMHA.apply = apply
        collectives._ReduceFromModelGroup.forward = staticmethod(reduce)

    def close(self) -> None:
        from oneprot_tpu_torch.core import collectives

        cli_train.build_model, Trainer._train_one = self.saved[:2]
        del flash_mha._FlashMHA.apply  # torch.autograd.Function's again
        collectives._ReduceFromModelGroup.forward = staticmethod(self.saved[3])


def tp_trainable(module) -> dict:
    """The trainable parameters as full tensors on the host (a shard's
    blocks joined over its model group: a collective of the group)."""
    from oneprot_tpu_torch.core import partitioning

    params = {n: p.detach() for n, p in module.model.named_parameters()
              if p.requires_grad}
    layout = {n: d for n, d in partitioning.layout_of(module.model).items()
              if n in params}
    return {n: t.cpu().clone() for n, t in
            partitioning.gather_state_dict(params, layout).items()}


def hub_bytes(module) -> int:
    """Bytes the hub's transformer holds on this rank (parameters and
    buffers)."""
    hub = module.encoders["sequence"].transformer
    return sum(t.numel() * t.element_size()
               for t in list(hub.parameters()) + list(hub.buffers()))


def tp_argv(name: str, root: str, run_dir: str, model: int,
            store: bool = False) -> list:
    """The phase's CLI overrides; with `store`, the feature cache's disk
    store under root (written by model rank 0, read by both)."""
    return list(TP_PHASES[name][0]) + [
        f"paths.data_dir={root}", f"hydra.run.dir={run_dir}",
        f"trainer.mesh.model={model}"] + (
        [f"trainer.cache_persist_dir={root}/{name}_store"] if store else [])


def tp_data(name: str, root: str) -> None:
    """The phase's synthetic data: records for CliDataModule (written to
    root/records.pt for the children) and the files read from disk."""
    rng = np.random.RandomState(TP_SEED)
    if name != "A":
        records = {"struct_token": struct_token_records(root, rng)}
    else:
        # chains of at most TP_LONGEST residues: the recipe packs the text
        # pairs into rows of 512 tokens, and `pack_stream` (the JAX
        # package's too) refuses a longer item
        records = graph_records(root, rng, TP_ITEMS, POCKET_RESIDUES,
                                longest=TP_LONGEST)
        records["text"] = {}
        for split, n in TP_ITEMS.items():
            ids = [f"{split}_{i:05d}" for i in range(n)]
            for sid in ids:
                records["text"][sid] = records["struct_graph"][sid][0]
            with open(os.path.join(root, f"{split}_text.csv"), "w") as f:
                f.write("".join(f"{sid},{x}\n" for sid, x in
                                zip(ids, sample_texts(n, rng))))
        seqsim_files(root, rng, TP_ITEMS)
    torch.save(records, os.path.join(root, "records.pt"))


def use_records(root: str) -> None:
    CliDataModule.RECORDS = torch.load(os.path.join(root, "records.pt"),
                                       weights_only=False)
    register_target_alias(CLI_DATA_TARGET, f"{__name__}.CliDataModule")


def tp_int8_rows() -> torch.Tensor:
    """The rows phase A's int8 hubs embed: 4 proteins of 100-254 residues
    in a batch of 256 tokens, from their own numpy seed."""
    rng = np.random.RandomState(TP_SEED + 1)
    ids = np.full((4, 256), 1, np.int64)
    for r, n in enumerate((254, 181, 130, 100)):
        ids[r, 1:n + 1] = rng.randint(4, 24, size=n)
        ids[r, 0], ids[r, n + 1] = 0, 2
    return torch.from_numpy(ids).cuda()


def tp_child(name: str, rank: int, root: str) -> int:
    """One rank of a tensor-parallel phase: the CLI run at mesh.model 2,
    then its control (phase A: the row-parallel bias added on every model
    rank; phase B: copy_to_model_group's backward without its all-reduce,
    its hub features read from the disk store the first run wrote, as the
    fault is in the tower's backward); phase A then runs the recipe with
    the int8 hub (TP_A_INT8) and pools `tp_int8_rows` through it.
    Writes root/<name>_rank<r>.json and .pt (and the batches on model rank
    0 of each data rank). Phase A runs under torch's deterministic
    algorithms; phase B without them, as a CLI run does by default: the
    ranks of a model group compute its replicated parts' gradients each,
    the towers' embedding and scatter backwards add with atomics, and the
    model group's sync (`optim.ClippedOptimizer`) must keep one replica.
    Phases B (and B32) record each step's gradients of the replicated
    parameters as the rank computed them, before that sync."""
    from oneprot_tpu_torch.core import collectives
    from oneprot_tpu_torch.core.mesh import data_world, model_world
    from oneprot_tpu_torch.models.layers import RowParallelDense
    from oneprot_tpu_torch.train.optim import ClippedOptimizer

    world_n = TP_PHASES[name][1]
    if name != "B":
        torch.use_deterministic_algorithms(True, warn_only=True)
    raw_grads = []
    sync_step = ClippedOptimizer.step

    def recording_step(opt):
        raw_grads.append([torch.zeros_like(p) if p.grad is None
                          else p.grad.detach().clone() for p in opt.replicated])
        sync_step(opt)
    count_plain_calls()
    init_distributed(f"file://{root}/rendezvous_{name}",
                     num_processes=world_n, process_id=rank, backend="gloo",
                     timeout_s=DDP_TIMEOUT_S)
    use_records(root)
    draw_biases(name == "A")
    out, state = {}, {}
    for run in ("run", "control"):
        if run == "control" and name == "A":
            def bias_everywhere(self, x):  # the classic fault
                dt = self.compute_dtype
                y = torch.nn.functional.linear(x.to(dt), self.weight.to(dt),
                                               self.bias.to(dt))
                return collectives.reduce_from_model_group(y).to(dt)
            RowParallelDense.forward = bias_everywhere
        elif run == "control":
            collectives._CopyToModelGroup.backward = staticmethod(
                lambda ctx, grad: grad)
        rec = TpRecorder(keep_batches=run == "run"
                         and model_world()[1] == 0)
        if name != "A" and run == "run":
            ClippedOptimizer.step = recording_step
        try:
            torch.cuda.synchronize()
            reset_launches()
            t = time.time()
            metrics = cli_train.main(tp_argv(
                name, root, f"{root}/{name}_{run}", 2, store=name != "A"))
            torch.cuda.synchronize()
            wall = time.time() - t
            out[f"{run}_disk_hits"] = metrics.get("cache/disk_hits")
        finally:
            rec.close()
            ClippedOptimizer.step = sync_step
        state[run] = tp_trainable(rec.module)
        if run == "run":
            state["initial"] = rec.initial
            out.update(
                tp=list(model_world()), data=list(data_world()), wall_s=wall,
                losses=rec.losses, step_ms=rec.step_ms,
                modalities=[m for m, _ in rec.steps],
                launches=read_launches(), plain=dict(PLAIN_CALLS),
                heads={str(k): v for k, v in rec.heads.items()},
                reduce_ms=rec.reduce_ms, hub_bytes=hub_bytes(rec.module),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                # the replicated trainable parameters as this rank holds them
                held={n: p.detach().cpu().clone() for n, p in
                      rec.module.model.named_parameters() if p.requires_grad
                      and getattr(p, "tp_dim", None) is None})
            if rec.keep_batches:
                torch.save(rec.steps, f"{root}/{name}_batches{rank}.pt")
        else:
            out["control_losses"] = rec.losses
        rec.module = None
        torch.cuda.empty_cache()
    if name == "A":
        rec = TpRecorder(keep_batches=False)
        try:
            reset_launches()
            cli_train.main(tp_argv(name, root, f"{root}/A_int8", 2)
                           + list(TP_A_INT8))
            torch.cuda.synchronize()
        finally:
            rec.close()
        hub = rec.module.encoders["sequence"].eval()
        with torch.no_grad():
            state["int8_pooled"] = hub.backbone_pooled(
                tp_int8_rows()).float().cpu()
        out["int8"] = {"launches": read_launches(), "losses": rec.losses,
                       "plain": dict(PLAIN_CALLS),
                       "hub_bytes": hub_bytes(rec.module),
                       "heads_split": any(layer.attn.heads_split for layer in
                                          hub.transformer.layers)}
        rec.module = hub = None
        torch.cuda.empty_cache()
    state["raw_grads"] = [[g.cpu() for g in step] for step in raw_grads]
    torch.save({**state, "held": out.pop("held")},
               f"{root}/{name}_rank{rank}.pt")
    with open(f"{root}/{name}_rank{rank}.json", "w") as f:
        json.dump(out, f)
    shutdown_distributed()
    return 0


def merge_batches(parts: list):
    """The data ranks' batches of one step as one process's batch: packed
    rows stacked, padded rows padded to the longest (pad id 1) and
    stacked, graph arrays stacked."""
    seqs, mods, modality, extras = zip(*parts)

    def stack(xs, pad=None):
        if pad is not None:
            width = max(x.shape[1] for x in xs)
            xs = [np.pad(x, ((0, 0), (0, width - x.shape[1])),
                         constant_values=pad) for x in xs]
        return np.concatenate(xs)

    if isinstance(seqs[0], dict):  # packed pairs
        return ({k: stack([s[k] for s in seqs]) for k in seqs[0]},
                {k: stack([m[k] for m in mods]) for k in mods[0]},
                modality[0], stack(extras))
    return (stack(seqs, 1), {k: stack([m[k] for m in mods]) for k in mods[0]},
            modality[0], [e for x in extras for e in x])


def tp_reference(name: str, root: str) -> dict:
    """The phase at mesh.model 1 in this process on both data ranks' rows
    together: phase A replays the data ranks' recorded batches merged
    (`merge_batches`) through the trainer's step, phase B (one data rank)
    runs the CLI itself. Returns its losses, initial and final trainable
    parameters, launches, heads, hub bytes."""
    from oneprot_tpu_torch.core.config import instantiate
    from oneprot_tpu_torch.train.trainer import select_device

    use_records(root)
    draw_biases(name == "A")
    rec = TpRecorder(keep_batches=False)
    try:
        reset_launches()
        argv = tp_argv(name, root, f"{root}/{name}_one", 1)
        if name != "A":
            cli_train.main(argv)
        else:
            cfg = cli_train.prepare(default_config_dir(), argv)
            module = cli_train.build_model(
                cfg["model"], select_device(cfg["trainer"]["accelerator"]),
                int(cfg["seed"]))
            trainer = instantiate(cfg["trainer"])
            module.gradient_clip_val = trainer.gradient_clip_val
            module.init()
            ranks = [torch.load(f"{root}/A_batches{r}.pt", weights_only=False)
                     for r in (0, 2)]
            for steps in zip(*ranks):
                trainer._train_one(module, steps[0][0],
                                   merge_batches([b for _, b in steps]))
        torch.cuda.synchronize()
    finally:
        rec.close()
        draw_biases(False)
    return {"losses": rec.losses, "initial": rec.initial,
            "final": tp_trainable(rec.module), "launches": read_launches(),
            "plain": dict(PLAIN_CALLS), "heads": rec.heads,
            "hub_bytes": hub_bytes(rec.module), "module": rec.module,
            "step_ms": rec.step_ms}


def tp_int8_reference(root: str):
    """Phase A's int8 hub in this process, whole at model 1: the recipe's
    sequence component with TP_A_INT8, its weights drawn as
    `cli.train.build_model` draws them (the seed's generator, the hub
    first) and stored as `OneProtModule.init` stores them, pooling
    `tp_int8_rows`. Returns (pooled, hub bytes)."""
    from oneprot_tpu_torch.core.config import instantiate

    cfg = cli_train.prepare(default_config_dir(), tp_argv(
        "A", root, f"{root}/A_int8_one", 1) + list(TP_A_INT8))
    components = cfg["model"]["components"]
    require(next(iter(components)) == "sequence",
            f"train_3b_tp draws {list(components)}: the hub must come first")
    draw_biases(True)
    try:
        hub = instantiate({**dict(components["sequence"]), "device": "cuda"})
        esm2.init_esm2_weights_(hub, torch.Generator(device="cuda").manual_seed(
            int(cfg["seed"])))
    finally:
        draw_biases(False)
    module = OneProtModule({"sequence": hub}).init()
    hub.eval()
    with torch.no_grad():
        pooled = hub.backbone_pooled(tp_int8_rows()).float().cpu()
    return pooled, hub_bytes(module)


def tensor_parallel_phase(name: str, smi: str, launches: dict,
                          min_cos: float = TP_DELTA_COS) -> dict:
    """Phase A or B: the ranks (children of this script) at mesh.model 2,
    then this process at model 1 on the same rows. Gated: each step's loss
    within TP_LOSS_REL, the trainable parameters' change (final minus
    seeded) at cosine >= TP_DELTA_COS against this process's and the
    control's below it (`min_cos`), every rank's trainable parameters and
    losses
    bit-identical (all replicated here, or joined), the seeded ones equal
    to this process's, #1 (and #2, #3) launched on each rank as often as
    here, each forward on the rank's half of the heads, no plain version;
    phase A: a rank's hub bytes <= TP_HUB_BYTES of this process's; phase
    B: its checkpoint restored at model 1 equals the file and the ranks'
    parameters exactly. Fills launches[f"tp {name} rank r"]."""
    world_n = TP_PHASES[name][1]
    out = {"world": world_n, "argv": list(TP_PHASES[name][0])}
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_tp{name}_") as root:
        t = time.time()
        tp_data(name, root)
        out["data_s"] = time.time() - t
        t = time.time()
        results = run_children(
            [([sys.executable, os.path.abspath(__file__), "--tp-child", name,
               str(rank), root], child_env(CUBLAS_WORKSPACE_CONFIG=":4096:8"))
             for rank in range(world_n)],
            DDP_TIMEOUT_S)
        out["children_s"] = time.time() - t
        for rank, (rc, log) in enumerate(results):
            require(rc == 0, f"tp {name} rank {rank} failed ({rc}):\n"
                    + log[-6000:])
        ranks, states = [], []
        for rank in range(world_n):
            with open(f"{root}/{name}_rank{rank}.json") as f:
                ranks.append(json.load(f))
            states.append(torch.load(f"{root}/{name}_rank{rank}.pt",
                                     weights_only=True))
        t = time.time()
        ref = tp_reference(name, root)
        out["reference_s"] = time.time() - t
        if name == "A":
            int8_one, int8_bytes = tp_int8_reference(root)
        if name != "A":
            path = f"{root}/{name}_run/checkpoints/last"
            module = ref["module"]
            checkpoint_lib.load_state(module, path)
            file = torch.load(os.path.join(path, checkpoint_lib.STATE_FILE),
                              weights_only=True)["model"]
            got = module.model.state_dict()
            restored = (set(got) == set(file) and all(
                torch.equal(got[k].cpu(), file[k]) for k in file) and all(
                torch.equal(file[k], states[0]["run"][k].to(file[k].dtype))
                for k in states[0]["run"]))
            out["checkpoint_restores_at_model_1"] = restored
        ref.pop("module")
        torch.cuda.empty_cache()
    want = np.array(ref["losses"])
    got = np.array(ranks[0]["losses"])
    rel = np.abs(got - want) / np.abs(want)
    start = ref["initial"]

    def change(state):
        return flat(state[n] - start[n] for n in start)

    want_change = change(ref["final"])
    cos = cosine(change(states[0]["run"]), want_change)
    control_cos = cosine(change(states[0]["control"]), want_change)
    same = all(r["losses"] == ranks[0]["losses"] for r in ranks) and all(
        torch.equal(s[k][n], states[0][k][n]) for s in states
        for k in ("run", "held") for n in states[0][k])
    seeded = all(torch.equal(states[0]["initial"][n], start[n]) for n in start)
    half = {str(h // 2): n for h, n in ref["heads"].items() if h % 2 == 0}
    for rank, r in enumerate(ranks):
        launches[f"tp {name} rank {rank}"] = r["launches"]
    per_forward = [float(np.sum(r["reduce_ms"])) for r in ranks]
    out.update({
        "losses": got.tolist(), "one_process_losses": want.tolist(),
        "loss_rel": rel.tolist(),
        "loss_margin": TP_LOSS_REL - float(rel.max()),
        "change_cosine": cos, "control_change_cosine": control_cos,
        "control_losses": ranks[0]["control_losses"],
        "ranks_bit_identical": same, "seeded_equal": seeded,
        "modalities": ranks[0]["modalities"],
        "heads_per_rank": ranks[0]["heads"],
        "one_process_heads": {str(k): v for k, v in ref["heads"].items()},
        "hub_bytes": [r["hub_bytes"] for r in ranks],
        "one_process_hub_bytes": ref["hub_bytes"],
        "step_ms": [r["step_ms"] for r in ranks],
        "one_process_step_ms": ref["step_ms"],
        "row_parallel_reduces": len(ranks[0]["reduce_ms"]),
        "row_parallel_reduce_ms": per_forward,
        "wall_s": [r["wall_s"] for r in ranks],
        "peak_gib": [r["peak_gib"] for r in ranks],
        "launches": ranks[0]["launches"],
        "one_process_launches": ref["launches"]})
    print(f"  tp {name}: {world_n} gloo ranks (data {world_n // 2} x model "
          f"2) in {out['children_s']:.1f} s with start-up, build and the "
          f"control; steps {out['modalities']}; losses "
          + ", ".join(f"{x:.4f}" for x in got) + " against one process "
          + ", ".join(f"{x:.4f}" for x in want)
          + f"; max rel {rel.max():.2e} (gate {TP_LOSS_REL}, margin "
          f"{out['loss_margin']:.2e}); change cosine {cos:.6f} (gate >= "
          f"{min_cos}), control {control_cos:.6f} (its losses "
          + ", ".join(f"{x:.4f}" for x in out["control_losses"])
          + f"); ranks bit-identical "
          f"{same}, seeded weights equal {seeded}; heads per forward "
          f"{out['heads_per_rank']} (one process {out['one_process_heads']});"
          f" hub bytes per rank {out['hub_bytes']} (one process "
          f"{ref['hub_bytes']}); median step ms "
          + ", ".join(f"rank {i} {np.median(r['step_ms']):.1f}"
                      for i, r in enumerate(ranks))
          + f" (one process {np.median(ref['step_ms']):.1f}); "
          f"{out['row_parallel_reduces']} row-parallel all-reduces a rank, "
          + ", ".join(f"{x:.1f}" for x in per_forward)
          + f" ms in all; disk-store hits {ranks[0].get('run_disk_hits')} / "
          f"control {ranks[0].get('control_disk_hits')}; launches per rank "
          f"{out['launches']}; {smi}",
          flush=True)
    for rank, r in enumerate(ranks):
        require(r["launches"] == ref["launches"], f"tp {name} rank {rank} "
                f"launches {r['launches']}, want {ref['launches']}")
        require(r["heads"] == half, f"tp {name} rank {rank} heads "
                f"{r['heads']}, want half of {ref['heads']}")
        require(not any(r["plain"].values()),
                f"tp {name} rank {rank}: plain versions ran: {r['plain']}")
    require(sum(ref["launches"].values()) > 0 and not any(
        ref["plain"].values()), f"tp {name} one process: launches "
        f"{ref['launches']}, plain {ref['plain']}")
    require(float(rel.max()) <= TP_LOSS_REL, f"tp {name} losses {out}")
    require(cos >= min_cos, f"tp {name} change cosine {cos}")
    require(control_cos < min_cos, f"tp {name}: the gate passed the "
            f"control: change cosine {control_cos}")
    require(same and seeded, f"tp {name}: ranks bit-identical {same}, "
            f"seeded equal {seeded}")
    if name == "A":
        require(max(out["hub_bytes"]) <= TP_HUB_BYTES * ref["hub_bytes"],
                f"tp A hub bytes {out['hub_bytes']} vs {ref['hub_bytes']}")
        out["int8"] = tp_int8_gates(ranks, states, int8_one, int8_bytes, smi,
                                    launches)
    else:
        out["raw_replicated_grads"] = raw_grad_parting(states, smi)
        require(out["checkpoint_restores_at_model_1"],
                "tp B: the model-2 checkpoint does not restore at model 1")
    return out


def tp_int8_gates(ranks: list, states: list, one: torch.Tensor,
                  one_bytes: int, smi: str, launches: dict) -> dict:
    """Phase A's int8 run: each rank's pooled hub features equal to this
    process's whole int8 hub's bit for bit, #4 launched on every rank, no
    split heads, no plain version; each rank's resident hub bytes against
    one process's. Fills launches["tp A int8 rank r"]."""
    equal = [torch.equal(s["int8_pooled"], one) for s in states]
    diffs = [float((s["int8_pooled"] - one).abs().max()) for s in states]
    res = {"bit_identical_to_one_process": equal, "max_abs_diff": diffs,
           "hub_bytes": [r["int8"]["hub_bytes"] for r in ranks],
           "one_process_hub_bytes": one_bytes,
           "gelu_quant_launches": [r["int8"]["launches"]["gelu_quant"]
                                   for r in ranks],
           "losses": [r["int8"]["losses"] for r in ranks]}
    res["hub_bytes_ratio"] = [b / one_bytes for b in res["hub_bytes"]]
    for rank, r in enumerate(ranks):
        launches[f"tp A int8 rank {rank}"] = r["int8"]["launches"]
    print(f"  tp A with the int8 hub ({' '.join(TP_A_INT8)}): pooled hub "
          f"features equal to one process's whole int8 hub bit for bit on "
          f"ranks {equal} (max abs diff {max(diffs):.3e}); #4 launches per "
          f"rank {res['gelu_quant_launches']}; resident hub bytes per rank "
          f"{res['hub_bytes']} against one process's {one_bytes} ("
          + ", ".join(f"{x:.4f}x" for x in res["hub_bytes_ratio"])
          + f"); losses {res['losses']}; {smi}", flush=True)
    require(all(equal), f"tp A int8: pooled features differ from one "
            f"process's: {diffs}")
    require(all(n > 0 for n in res["gelu_quant_launches"]),
            f"tp A int8: #4 not launched on every rank: "
            f"{res['gelu_quant_launches']}")
    require(not any(r["int8"]["heads_split"] for r in ranks),
            "tp A int8: the int8 hub split its heads")
    require(not any(any(r["int8"]["plain"].values()) for r in ranks),
            "tp A int8: plain versions ran on the card")
    require(all(np.isfinite(r["int8"]["losses"]).all() for r in ranks),
            f"tp A int8: losses {res['losses']}")
    return res


def raw_grad_parting(states: list, smi: str) -> dict:
    """Phase B ran without deterministic algorithms: the two model ranks'
    gradients of the replicated parameters as each computed them, before
    the model group's sync, step by step: the largest difference and the
    share of parameters that differ at all (printed, not gated; the gate
    is that the replicas after the steps are bit-identical)."""
    a, b = (s["raw_grads"] for s in states[:2])
    require(len(a) == len(b) > 0, f"tp B: {len(a)} and {len(b)} recorded "
            "optimizer steps")
    steps = []
    for ga, gb in zip(a, b):
        diffs = [float((x.float() - y.float()).abs().max()) if x.numel()
                 else 0.0 for x, y in zip(ga, gb)]
        steps.append({"max_abs_diff": max(diffs),
                      "params_differing": sum(d > 0 for d in diffs),
                      "params": len(diffs)})
    print("  tp B, deterministic algorithms off: the model ranks' raw "
          "replicated gradients before the sync, per step: " + "; ".join(
              f"max |rank 0 - rank 1| {x['max_abs_diff']:.3e} in "
              f"{x['params_differing']} of {x['params']} parameters"
              for x in steps) + f"; {smi}", flush=True)
    return {"steps": steps}


def serve_struct_tokens(run_dir: str, launches: dict) -> dict:
    """`OneProtEmbedder.from_run_dir(run_dir).embed_struct_tokens` on one
    request of 32 3Di strings (log-normal lengths): finite embeddings of
    norm 1/0.07 (the tower's fixed logit scale), 12 #1 launches (one tower forward) and nothing else. Fills
    launches["struct_tokens"]."""
    rng = np.random.RandomState(TRAINER_SEED + 1)
    tdi = ["".join(rng.choice(list(FOLDSEEK), len(s)))
           for s in sample_seqs(32, rng)]
    embedder = OneProtEmbedder.from_run_dir(run_dir)
    torch.cuda.synchronize()
    reset_launches()
    t = time.time()
    feats = embedder.embed_struct_tokens(tdi, batch_size=32)
    request_ms = (time.time() - t) * 1e3
    launches["struct_tokens"] = read_launches()
    require(not any(PLAIN_CALLS.values()),
            f"struct tokens: plain versions ran on the card: {PLAIN_CALLS}")
    # the tower's head scales its unit vectors by 1 / 0.07
    require(feats.shape == (32, 1024) and bool(np.isfinite(feats).all())
            and bool(np.allclose(np.linalg.norm(feats, axis=-1), 1 / 0.07,
                                 rtol=1e-2)), "embed_struct_tokens features")
    want = {**{name: 0 for name in LAUNCHERS}, "flash_mha_fwd": TOWER_LAYERS}
    require(launches["struct_tokens"] == want, f"embed_struct_tokens "
            f"launches {launches['struct_tokens']}, want {want}")
    print(f"  embed_struct_tokens from the run dir: one request of 32 in "
          f"{request_ms:.1f} ms; launches {launches['struct_tokens']}",
          flush=True)
    del embedder
    return {"request_ms": request_ms, "launches": launches["struct_tokens"]}


def lora_batch(rng, n: int = LORA_BATCH, max_res: int = 1022):
    """n (sequence, 3Di) pairs for the unpacked step: log-normal lengths
    around 290 residues clipped to [30, max_res], hub tokens 4..23 and
    struct tokens 20..52 between <cls> and <eos>, both sides padded to the
    smallest of BUCKETS that fits the longest."""
    lens = np.clip(rng.lognormal(np.log(290.0), 0.65, n), 30, max_res).astype(int)
    L = min(b for b in BUCKETS if b >= lens.max() + 2)
    ids, st_ids = np.full((n, L), 1, np.int32), np.full((n, L), 1, np.int32)
    for i, m in enumerate(lens):
        ids[i, 1:m + 1] = rng.randint(4, 24, size=m)
        st_ids[i, 1:m + 1] = rng.randint(20, 53, size=m)
        ids[i, [0, m + 1]] = st_ids[i, [0, m + 1]] = (0, 2)
    return ids, st_ids


def lora_module(hub_cfg, tower_cfg, device, dtype, lora_dropout,
                remat) -> OneProtModule:
    """The LoRA step's module on `device`: the hub with LoRA on q, k, v
    (frozen weights, mlp head) and the struct-token tower, CLIP + L1,
    clipped Adam at SMOKE_LR."""
    hub = SequenceEncoder(
        hub_cfg, 1024, proj_type="mlp", frozen=True,
        lora=esm2.LoraConfig(LORA["lora_r"], float(LORA["lora_alpha"]),
                             lora_dropout),
        remat=remat, device=device, dtype=dtype)
    tower = StructTokenEncoder(tower_cfg, 1024, device=device, dtype=dtype)
    return build_module(hub, tower)


def lora_step_split(module: OneProtModule, ids, st_ids) -> dict:
    """One more train_step, taken apart and timed by CUDA events: forward
    (both towers and the loss), backward (the remat recompute with it),
    clip + Adam."""
    seq_ids, mod_ids = (module._tensor(x, torch.long) for x in (ids, st_ids))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    module._begin_step()
    seq_feats = module.model(seq_ids, "sequence")
    loss = module._loss_value(module.model(mod_ids, "struct_token"), seq_feats)
    ev[1].record()
    module.opt.zero_grad()
    loss.backward()
    ev[2].record()
    module.opt.step()
    module.step += 1
    ev[3].record()
    torch.cuda.synchronize()
    split = {"forward_ms": ev[0].elapsed_time(ev[1]),
             "backward_ms": ev[1].elapsed_time(ev[2]),
             "clip_adam_ms": ev[2].elapsed_time(ev[3])}
    split["step_ms"] = sum(split.values())
    return split


# groups of the LoRA step's device time, by kernel name (first match wins)
PROFILE_GROUPS = (("#6 FA-2 dq", ("flash_attention_bwd_dq",)),
                  ("#7 FA-2 dk/dv", ("flash_attention_bwd_dkv",)),
                  ("#5 FA-2 forward", ("flash_attention_fwd",)),
                  ("#1-#3 flash-MHA (tower)", ("flash_mha",)),
                  ("GEMMs", ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                             "splitk")),
                  ("LoRA dropout draws", ("distribution", "philox",
                                          "bernoulli")))


def lora_step_profile(module: OneProtModule, ids, st_ids) -> dict:
    """One more train_step under torch.profiler: device time by kernel,
    summed into PROFILE_GROUPS and the rest, the step's wall time and the
    device's busy share of it. Empty groups if the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        module.train_step("struct_token", ids, st_ids)[0].item()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["rest"] = 0.0
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        ms = evt.self_device_time_total / 1e3
        kernels[evt.key] = kernels.get(evt.key, 0.0) + ms
        low = evt.key.lower()
        group = next((name for name, keys in PROFILE_GROUPS
                      if any(k in low for k in keys)), "rest")
        groups[group] += ms
    device_ms = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "groups_ms": groups,
            "top_kernels_ms": [[name[:120], ms] for name, ms in top]}


def train_lora_hub(smi: str, launches: dict):
    """The LoRA-15B unpacked step at full width (random weights from a
    seed); fills `launches`. Returns (numbers, (the hub's and the tower's
    first 2 layers as they were before the first step, their configs))."""
    # the entry points: the committed config dir, LoRA, frozen bf16, remat
    hub = create_sequence_encoder(model_name_or_path=str(WIDE_HUB),
                                  proj_type="mlp", frozen=True, remat=True,
                                  **LORA)
    cfg = hub.config
    require((cfg.num_layers, cfg.hidden_size, cfg.num_heads) == (WIDE_LAYERS,
                                                               5120, 40),
            f"ESM2-15B widths: {cfg}")
    esm2.init_esm2_weights_(hub, torch.Generator(device="cuda").manual_seed(6))
    tower = create_struct_token_encoder()
    esm2.init_esm2_weights_(tower, torch.Generator(device="cuda").manual_seed(7))
    module = build_module(hub, tower)
    initial = (first_layers(hub.state_dict(), 2),
               first_layers(tower.state_dict(), 2), cfg, tower.config)
    n_train = sum(p.numel() for p in module.opt.params)
    n_hub_train = sum(p.numel() for n, p in hub.transformer.named_parameters()
                      if p.requires_grad)
    rng = np.random.RandomState(8)
    batches = [lora_batch(rng) for _ in range(LORA_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, secs = [], []
    for ids, st_ids in batches[:LORA_STEPS]:
        t = time.time()
        loss, _ = module.train_step("struct_token", ids, st_ids)
        losses.append(loss.item())  # waits for the step
        secs.append(time.time() - t)
    launches["LoRA-15B step"] = read_launches()
    per_step = {**{name: 0 for name in LAUNCHERS},
                "flash_attention_fwd": 2 * WIDE_LAYERS,  # forward + recompute
                "flash_attention_bwd_dq": WIDE_LAYERS,
                "flash_attention_bwd_dkv": WIDE_LAYERS,
                "flash_mha_fwd": TOWER_LAYERS, "flash_mha_bwd_dq": TOWER_LAYERS,
                "flash_mha_bwd_dkv": TOWER_LAYERS}
    want = {k: LORA_STEPS * n for k, n in per_step.items()}
    require(launches["LoRA-15B step"] == want,
            f"LoRA-15B launches {launches['LoRA-15B step']}, want {want}")
    require(not any(PLAIN_CALLS.values()),
            f"LoRA-15B: plain versions ran on the card: {PLAIN_CALLS}")
    require(bool(np.isfinite(losses).all()), f"LoRA-15B losses {losses}")
    require(all(torch.isfinite(p).all().item() for p in module.opt.params),
            "LoRA-15B: non-finite parameters after the steps")
    peak = torch.cuda.max_memory_allocated() / 2**30
    packed = lora_packed_steps(module, per_step, launches, smi)
    # the adapters through peft's layout and back, bit for bit
    from oneprot_tpu_torch.models.hf_convert import (
        export_peft_lora,
        import_peft_lora,
    )

    t = time.time()
    adapters = {k: v.cpu() for k, v in hub.transformer.state_dict().items()
                if "lora_" in k}
    back = import_peft_lora(export_peft_lora(adapters, WIDE_LAYERS), {},
                            WIDE_LAYERS)
    peft_s = time.time() - t
    require(sorted(back) == sorted(adapters) and len(adapters) == 6 * WIDE_LAYERS
            and all(torch.equal(back[k], v) for k, v in adapters.items()),
            "LoRA-15B: peft export/import does not give the adapters back")
    split = lora_step_split(module, *batches[-1])
    prof = lora_step_profile(module, *batches[-1])
    lens = [int((ids != 1).sum(1).max()) for ids, _ in batches]
    pairs_s = [LORA_BATCH / x for x in secs]
    print(f"  LoRA-15B: {n_train / 1e6:.2f} M trainable parameters "
          f"({n_hub_train / 1e6:.2f} M in the hub's transformer); buckets "
          + ", ".join(str(ids.shape[1]) for ids, _ in batches)
          + f" (longest rows {lens}); losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; step ms "
          + ", ".join(f"{x * 1e3:.1f}" for x in secs) + "; pairs/s "
          + ", ".join(f"{x:.2f}" for x in pairs_s)
          + f"; peak device memory {peak:.2f} GiB; launches per step "
          f"{per_step}; {smi}", flush=True)
    print(f"  LoRA-15B step split (CUDA events, bucket {batches[-1][0].shape[1]}):"
          f" forward {split['forward_ms']:.1f} ms, backward with recompute "
          f"{split['backward_ms']:.1f} ms, clip + Adam "
          f"{split['clip_adam_ms']:.1f} ms", flush=True)
    if prof["device_ms"] > 0:
        print(f"  LoRA-15B step profile (torch.profiler, bucket "
              f"{batches[-1][0].shape[1]}): wall {prof['wall_ms']:.1f} ms, "
              f"device {prof['device_ms']:.1f} ms (busy "
              f"{100 * prof['busy_share']:.1f}%): " + ", ".join(
                  f"{name} {ms:.1f} ms ({100 * ms / prof['device_ms']:.1f}%)"
                  for name, ms in prof["groups_ms"].items()), flush=True)
        print("  top kernels: " + "; ".join(
            f"{name} {ms:.1f} ms" for name, ms in prof["top_kernels_ms"]),
            flush=True)
    else:
        print("  LoRA-15B step profile: torch.profiler showed no device time; "
              "the CUDA-event split above stands", flush=True)
    result = {"losses": losses, "step_ms": [x * 1e3 for x in secs],
              "pairs_per_s": pairs_s, "buckets": [ids.shape[1] for ids, _ in
                                                  batches[:LORA_STEPS]],
              "trainable_params": n_train, "hub_trainable_params": n_hub_train,
              "peak_gib": peak, "launches_per_step": per_step,
              "split": split, "profile": prof, "packed": packed,
              "peft_round_trip": {"tensors": len(adapters), "s": peft_s}}
    print(f"  LoRA-15B adapters: peft export + import of {len(adapters)} "
          f"tensors in {peft_s:.3f} s, bit for bit", flush=True)
    return result, initial


def lora_packed_steps(module: OneProtModule, per_step: dict, launches: dict,
                      smi: str) -> dict:
    """LORA_PACKED_STEPS `train_step_packed`s of the LoRA-15B module on
    fresh batches at train_packed.yaml's packing: the hub's heads of 128
    through #5-#7 with segment ids, the tower's through #1-#3. Gated: the
    launches of `per_step` each step, no plain version, finite losses and
    parameters. Fills launches["LoRA-15B packed step"]."""
    rng = np.random.RandomState(12)
    batches = [make_packed_batch(rng) for _ in range(LORA_PACKED_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, secs = [], []
    for b in batches:
        t = time.time()
        loss, _ = module.train_step_packed("struct_token", b["seq"], b["mod"],
                                           b["valid"])
        losses.append(loss.item())  # waits for the step
        secs.append(time.time() - t)
    launches["LoRA-15B packed step"] = read_launches()
    want = {k: LORA_PACKED_STEPS * n for k, n in per_step.items()}
    require(launches["LoRA-15B packed step"] == want,
            f"LoRA-15B packed launches {launches['LoRA-15B packed step']}, "
            f"want {want}")
    require(not any(PLAIN_CALLS.values()),
            f"LoRA-15B packed: plain versions ran on the card: {PLAIN_CALLS}")
    require(bool(np.isfinite(losses).all()), f"LoRA-15B packed losses {losses}")
    require(all(torch.isfinite(p).all().item() for p in module.opt.params),
            "LoRA-15B packed: non-finite parameters after the steps")
    pairs = [int(b["valid"].sum()) for b in batches]
    seg = torch.from_numpy(np.concatenate([b["seq"]["segment_ids"]
                                           for b in batches])).cuda()
    tiles = {"#5": flash_mha.segment_tile_hits(
        seg, fa.fwd_key_tile(128), fa.BLOCK).float().mean().item(),
        "#6 and #7": flash_mha.segment_tile_hits(
            seg, fa.TILE, fa.BLOCK).float().mean().item()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  LoRA-15B packed ({ROWS} rows of {ROW_LEN}, {SLOTS} slots): "
          f"proteins {pairs}; losses " + ", ".join(f"{x:.4f}" for x in losses)
          + "; step ms " + ", ".join(f"{x * 1e3:.1f}" for x in secs)
          + "; pairs/s " + ", ".join(f"{n / x:.2f}" for n, x in
                                      zip(pairs, secs))
          + f"; FA-2 tiles visited {tiles}; peak device memory {peak:.2f} "
          f"GiB; launches per step as unpacked; {smi}", flush=True)
    return {"losses": losses, "step_ms": [x * 1e3 for x in secs],
            "pairs": pairs, "pairs_per_s": [n / x for n, x in zip(pairs, secs)],
            "tiles_visited": tiles, "peak_gib": peak,
            "launches_per_step": per_step}


def lora_parity(hub_state: dict, tower_state: dict, hub_cfg, tower_cfg,
                packed: bool = False) -> dict:
    """Two steps at 2 hub + 2 tower layers from the LoRA step's
    initial weights (B = 0), LoRA dropout 0, card (bf16, kernels, remat)
    vs CPU (f32, plain versions): unpacked on WIDE_PARITY_ROWS pairs up to
    254 residues, or `packed` on WIDE_PARITY_ROWS rows of
    LORA_PARITY_ROW_LEN tokens (the hub's heads of 128 through #5-#7 with
    segment ids on the card, the dense mask on the CPU). On
    step 1 B = 0 gives A no gradient: each layer's q, k, v lora_B gradients
    are held. Step 2 starts both from the CPU's weights after step 1 (Adam's
    first update is lr * sign(g) wherever |g| >> eps, so a gradient that
    differs in its last digits flips some of B's entries; the copy keeps
    that out of the comparison): each layer's lora_A gradients are held.
    The hub's bias gradients (all biases of its transformer, as one vector)
    are held at both steps."""
    if packed:
        batch = make_packed_batch(np.random.RandomState(10), WIDE_PARITY_ROWS,
                                  LORA_PARITY_ROW_LEN, LORA_PARITY_SLOTS,
                                  median=60.0)
        step = lambda m: m.train_step_packed("struct_token", batch["seq"],
                                             batch["mod"], batch["valid"])
    else:
        ids, st_ids = lora_batch(np.random.RandomState(9), WIDE_PARITY_ROWS,
                                 254)
        step = lambda m: m.train_step("struct_token", ids, st_ids)
    what = "packed " if packed else ""
    cfg_h = dataclasses.replace(hub_cfg, num_layers=2)
    cfg_t = dataclasses.replace(tower_cfg, num_layers=2)
    state = {**{"encoders.sequence." + k: v for k, v in hub_state.items()},
             **{"encoders.struct_token." + k: v for k, v in tower_state.items()}}
    mods = {"cuda": lora_module(cfg_h, cfg_t, "cuda", torch.bfloat16, 0.0, True),
            "cpu": lora_module(cfg_h, cfg_t, "cpu", torch.float32, 0.0, False)}
    for m in mods.values():
        m.model.load_state_dict(state)
    out = {"steps": []}
    for n_step, factor in ((1, "lora_B"), (2, "lora_A")):
        if n_step == 2:
            with torch.no_grad():
                for pc, pg in zip(mods["cpu"].opt.params, mods["cuda"].opt.params):
                    pg.copy_(pc)
        runs = {}
        for device, m in mods.items():
            loss, _ = step(m)
            runs[device] = {"loss": loss.item(), "grad": {
                n: p.grad for n, p in m.model.named_parameters()
                if p.grad is not None}}
        card, cpu = runs["cuda"], runs["cpu"]
        require(card["grad"].keys() == cpu["grad"].keys(), "gradient leaves differ")
        hub = "encoders.sequence.transformer."
        factors = {n: cosine(flat([card["grad"][n]]), flat([cpu["grad"][n]]))
                   for n in card["grad"] if n.startswith(hub) and n.endswith(factor)}
        require(len(factors) == 2 * 3, f"{factor} gradient leaves: {sorted(factors)}")
        biases = [n for n in card["grad"] if n.startswith(hub) and n.endswith("bias")]
        row = {"step": n_step, "loss_card": card["loss"], "loss_cpu": cpu["loss"],
               "loss_rel_diff": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
               f"{factor}_grad_cosine": factors,
               "hub_bias_grad_cosine": cosine(
                   flat(card["grad"][n] for n in biases),
                   flat(cpu["grad"][n] for n in biases)),
               "hub_bias_leaves": len(biases)}
        print(f"  LoRA {what}step {n_step}, card vs CPU: loss {card['loss']:.6f} vs "
              f"{cpu['loss']:.6f} (rel diff {row['loss_rel_diff']:.2e}, gate <= "
              f"2e-2); {factor} gradient cosine per layer and projection, least "
              f"{min(factors.values()):.5f} (gate >= 0.99); the hub's "
              f"{len(biases)} bias gradients as one vector: cosine "
              f"{row['hub_bias_grad_cosine']:.5f} (gate >= 0.99)", flush=True)
        require(row["loss_rel_diff"] <= 2e-2,
                f"LoRA {what}step {n_step} loss parity {row['loss_rel_diff']}")
        require(min(factors.values()) >= 0.99,
                f"LoRA {what}step {n_step} {factor} gradient parity {factors}")
        require(row["hub_bias_grad_cosine"] >= 0.99,
                f"LoRA {what}step {n_step} hub bias gradient parity "
                f"{row['hub_bias_grad_cosine']}")
        out["steps"].append(row)
    return out


def check_embeddings(feats: np.ndarray, n: int, what: str) -> None:
    require(feats.shape == (n, 1024), f"{what}: shape {feats.shape}")
    require(bool(np.isfinite(feats).all()), f"{what}: non-finite embeddings")
    norms = np.linalg.norm(feats, axis=-1)
    require(bool(np.all(np.abs(norms - 1.0) <= 1e-2)),
            f"{what}: norms {norms.min()}..{norms.max()}")


def serve(embedder, requests, what: str):
    """Answer the requests; returns (embeddings, seconds per request)."""
    feats, secs = [], []
    for req in requests:
        t = time.time()
        feats.append(embedder.embed_sequences(req, batch_size=32))
        secs.append(time.time() - t)
        check_embeddings(feats[-1], len(req), what)
    n = sum(len(r) for r in requests)
    print(f"  {what}: {n} sequences in {sum(secs):.3f} s = "
          f"{n / sum(secs):.1f} seq/s (requests: "
          + ", ".join(f"{s * 1e3:.1f} ms" for s in secs) + ")", flush=True)
    return np.concatenate(feats), secs


def check_retrieval(embedder, feats: np.ndarray, rng, what: str) -> None:
    pool = rng.randn(1024, 1024).astype(np.float32)
    pool[:len(feats)] = feats
    queries = feats[:32]
    n = len(queries)
    scores, idx = embedder.retrieve(queries, pool, k=10)
    require(idx.shape == (n, 10), f"{what} retrieve: shape {idx.shape}")
    require(bool(np.all(idx[:, 0] == np.arange(n))),
            f"{what} retrieve: a query's nearest pool entry is not itself")
    require(bool(np.all(np.abs(scores[:, 0] - 1.0) < 1e-3)),
            f"{what} retrieve: top score {scores[:, 0].min()}")
    print(f"  {what}: retrieve(k=10) over 1024 pool entries: every query "
          f"finds itself first", flush=True)


def write_msas(root: str, rng, n: int, homologs: int = HOMOLOGS) -> list:
    """n synthetic .a3m files: a query of log-normal length around 290
    residues clipped to [20, 1022] (as sample_seqs) and `homologs` point
    mutants of it, each with '-' gaps and lowercase insertions, so that
    read_msa and greedy_select do real work."""
    paths = []
    for i, n_res in enumerate(np.clip(rng.lognormal(np.log(290.0), 0.75, n),
                                      20, 1022).astype(int)):
        query = rng.choice(list(AAS), n_res)
        lines = [">query", "".join(query)]
        for h in range(homologs):
            row = query.copy()
            mutate = rng.rand(n_res) < rng.uniform(0.05, 0.6)
            row[mutate] = rng.choice(list(AAS), int(mutate.sum()))
            row[rng.rand(n_res) < 0.1] = "-"
            inserts = rng.rand(n_res) < 0.03
            lines += [f">homolog_{h}", "".join(
                ch + ("".join(rng.choice(list(AAS.lower()), rng.randint(1, 4)))
                      if ins else "") for ch, ins in zip(row, inserts))]
        paths.append(os.path.join(root, f"msa_{i:03d}.a3m"))
        with open(paths[-1], "w") as f:
            f.write("\n".join(lines) + "\n")
    return paths


def serve_msas(root: str, gen, rng, smi: str, launches: dict):
    """The MSA-1b serving path at full width, on .a3m files it writes under
    `root`; fills `launches`. Returns (numbers, the tower's state, the
    requests' files)."""
    paths = write_msas(root, rng, MSA_REQUESTS * MSAS_PER_REQUEST)
    requests = [paths[i:i + MSAS_PER_REQUEST]
                for i in range(0, len(paths), MSAS_PER_REQUEST)]
    # the entry point's defaults: esm_msa1b, 1024 wide mlp head, bf16, card
    enc = create_msa_encoder()
    require(enc.config.num_layers == MSA_LAYERS
            and enc.config.hidden_size == 768 and enc.config.num_heads == 12
            and enc.config.intermediate_size == 3072,
            f"MSA-1b widths: {enc.config}")
    msa_transformer.init_msa_weights_(enc, gen)
    embedder = OneProtEmbedder(OneProtModel({"msa": enc}))
    reset_launches()
    feats, secs = [], []
    for req in requests:
        t = time.time()
        feats.append(embedder.embed_msas(req))  # depth 16, batch 4, 1024
        secs.append(time.time() - t)
    launches["MSA-1b serving"] = read_launches()
    batches = sum(-(-len(r) // 4) for r in requests)
    want = {name: 0 for name in LAUNCHERS}
    want["tied_row_attention"] = MSA_LAYERS * batches
    require(launches["MSA-1b serving"] == want,
            f"MSA-1b launches {launches['MSA-1b serving']}, want {want}")
    require(not any(PLAIN_CALLS.values()),
            f"MSA serving: plain versions ran on the card: {PLAIN_CALLS}")
    feats = np.concatenate(feats)
    n = len(paths)
    require(feats.shape == (n, 1024), f"MSA-1b: shape {feats.shape}")
    require(bool(np.isfinite(feats).all()), "MSA-1b: non-finite embeddings")
    norms = np.linalg.norm(feats, axis=-1)
    require(bool(np.all(np.abs(norms * 0.07 - 1.0) <= 1e-3)),
            f"MSA-1b: norms {norms.min()}..{norms.max()}, want 1/0.07")
    check_retrieval(embedder, feats, rng, "MSA-1b")
    print(f"  MSA-1b: {n} MSAs (depth {MSA_DEPTH}, {HOMOLOGS} homologs each) "
          f"in {sum(secs):.3f} s = {n / sum(secs):.2f} MSAs/s (requests: "
          + ", ".join(f"{x * 1e3:.1f} ms" for x in secs)
          + f"); launches {launches['MSA-1b serving']}; {smi}", flush=True)
    result = {"msas": n, "requests": len(requests),
              "msas_per_s": n / sum(secs),
              "request_ms": [x * 1e3 for x in secs]}
    return result, enc.state_dict(), requests


def msa_parity(state: dict, paths: list) -> dict:
    """The tower's first 2 layers and its head, card (bf16, kernel) against
    CPU (f32, plain version), on the same MSAs through embed_msas: the
    tower's [B, R, L, H] output token by token (min cosine over every
    unpadded token of every row) and the embeddings (mean cosine)."""
    state2 = first_layers(state, 2)
    outs, towers = [], []
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        enc = create_msa_encoder(num_layers=2, device=device, dtype=dtype)
        enc.load_state_dict(state2)
        hook = enc.transformer.register_forward_hook(
            lambda _, args, out: towers.append((args[0].cpu(),
                                                out.float().cpu())))
        outs.append(OneProtEmbedder(OneProtModel({"msa": enc})).embed_msas(paths))
        hook.remove()
    require(len(towers) == 2, f"MSA parity: {len(towers)} tower runs, want 2 "
            f"(one batch on each device)")
    (tok_card, card), (tok_cpu, cpu) = towers
    require(torch.equal(tok_card, tok_cpu), "MSA parity: tokens differ")
    keep = tok_cpu != msa_transformer.MsaTransformerConfig().pad_token_id
    token_cos = torch.nn.functional.cosine_similarity(card[keep], cpu[keep],
                                                      dim=-1)
    rel = float((card[keep] - cpu[keep]).abs().max() / cpu[keep].abs().max())
    result = {"tower_min_token_cosine": float(token_cos.min()),
              "tower_mean_token_cosine": float(token_cos.mean()),
              "tower_max_rel_err": rel, "tokens": int(keep.sum()),
              "embedding_mean_cosine": mean_cosine(*outs)}
    print(f"  MSA-1b at 2 layers, card vs CPU: tower output over "
          f"{result['tokens']} tokens: min cosine "
          f"{result['tower_min_token_cosine']:.6f} (gate >= "
          f"{MSA_TOKEN_COS}), mean {result['tower_mean_token_cosine']:.6f}, "
          f"max rel err {rel:.3e}; embeddings mean cosine "
          f"{result['embedding_mean_cosine']:.6f} (gate >= 0.999)", flush=True)
    require(result["tower_min_token_cosine"] >= MSA_TOKEN_COS,
            f"MSA tower parity: a token's cosine "
            f"{result['tower_min_token_cosine']} < {MSA_TOKEN_COS}")
    require(result["embedding_mean_cosine"] >= 0.999,
            f"MSA parity {result['embedding_mean_cosine']} < 0.999")
    return result


def serve_msas_query_row(state: dict, requests: list, smi: str,
                         launches: dict) -> dict:
    """MSA-1b serving with `use_all_msa=False` (msa.yaml's pooling_type
    'identity' becomes 'mean' over the query row, as `create_msa_encoder`
    has it) on the serving phase's weights and first request: #8 exactly
    12 launches a batch and nothing else, finite embeddings of norm 1/0.07;
    then its first 2 layers card (bf16, kernel) vs CPU (f32, plain) on the
    request's first 2 MSAs at the MSA parity's embedding bar. Fills
    launches["MSA-1b query row"]."""
    enc = create_msa_encoder(use_all_msa=False)
    require(enc.pooling_type == "mean" and not enc.use_all_msa,
            f"query-row pooling: {enc.pooling_type}")
    enc.load_state_dict(state)
    embedder = OneProtEmbedder(OneProtModel({"msa": enc}))
    reset_launches()
    t = time.time()
    feats = embedder.embed_msas(requests[0])
    secs = time.time() - t
    launches["MSA-1b query row"] = read_launches()
    want = {name: 0 for name in LAUNCHERS}
    want["tied_row_attention"] = MSA_LAYERS * -(-len(requests[0]) // 4)
    require(launches["MSA-1b query row"] == want,
            f"MSA-1b query row launches {launches['MSA-1b query row']}, "
            f"want {want}")
    require(not any(PLAIN_CALLS.values()),
            f"MSA query row: plain versions ran on the card: {PLAIN_CALLS}")
    norms = np.linalg.norm(feats, axis=-1)
    require(feats.shape == (len(requests[0]), 1024)
            and bool(np.isfinite(feats).all())
            and bool(np.all(np.abs(norms * 0.07 - 1.0) <= 1e-3)),
            f"MSA-1b query row: shape {feats.shape}, norms {norms}")
    del embedder, enc
    outs = []
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        enc = create_msa_encoder(num_layers=2, use_all_msa=False,
                                 device=device, dtype=dtype)
        enc.load_state_dict(first_layers(state, 2))
        outs.append(OneProtEmbedder(OneProtModel({"msa": enc})).embed_msas(
            requests[0][:2]))
    cos = mean_cosine(*outs)
    print(f"  MSA-1b, the query row pooled (use_all_msa=False, mean): "
          f"{len(requests[0])} MSAs in {secs * 1e3:.1f} ms = "
          f"{len(requests[0]) / secs:.2f} MSAs/s; launches "
          f"{launches['MSA-1b query row']}; 2 layers card vs CPU: embeddings "
          f"mean cosine {cos:.6f} (gate >= 0.999); {smi}", flush=True)
    require(cos >= 0.999, f"MSA query-row parity {cos} < 0.999")
    return {"msas": len(requests[0]), "request_ms": secs * 1e3,
            "msas_per_s": len(requests[0]) / secs, "parity_mean_cosine": cos}


def serve_wide_hub(smi: str, launches: dict):
    """The hub at the ESM2-15B width (random weights from a seed, bf16,
    ~30 GB on the card) answers 3 requests of 32 sequences drawn from its
    own numpy stream; fills `launches`. Returns (numbers, its first 2
    layers' state on the CPU, its config); the caller frees the hub."""
    # the entry point on the config directory: 1024 wide mlp head, bf16, card
    enc = create_sequence_encoder(model_name_or_path=str(WIDE_HUB),
                                  proj_type="mlp")
    cfg = enc.config
    require((cfg.num_layers, cfg.hidden_size, cfg.num_heads,
             cfg.intermediate_size) == (WIDE_LAYERS, 5120, 40, 20480),
            f"ESM2-15B widths: {cfg}")
    esm2.init_esm2_weights_(enc, torch.Generator(device="cuda").manual_seed(5))
    n_params = sum(p.numel() for p in enc.parameters())
    rng = np.random.RandomState(3)
    requests = [sample_seqs(32, rng) for _ in range(3)]
    embedder = OneProtEmbedder(OneProtModel({"sequence": enc}), buckets=BUCKETS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    feats, secs = serve(embedder, requests, "ESM2-15B-width hub")
    launches["15B hub"] = read_launches()
    batches = len(requests)  # 32 sequences a request, batch_size 32
    want = {name: 0 for name in LAUNCHERS}
    want["flash_attention_fwd"] = WIDE_LAYERS * batches
    require(launches["15B hub"] == want,
            f"15B hub launches {launches['15B hub']}, want {want}")
    require(not any(PLAIN_CALLS.values()),
            f"15B hub: plain versions ran on the card: {PLAIN_CALLS}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_retrieval(embedder, feats, rng, "15B hub")
    state2 = first_layers(enc.state_dict(), 2)
    del embedder, enc
    n = sum(len(r) for r in requests)
    print(f"  15B hub: {n_params / 1e9:.3f} B parameters; launches "
          f"{launches['15B hub']}; peak device memory {peak:.2f} GiB (both "
          f"hubs' weights included); {smi}", flush=True)
    result = {"sequences": n, "requests": len(requests),
              "seq_per_s": n / sum(secs), "request_ms": [x * 1e3 for x in secs],
              "params": n_params, "peak_gib": peak}
    return result, state2, cfg


def wide_hub_parity(state: dict, cfg) -> dict:
    """The 15B-width hub's first 2 layers and its head, card (bf16, kernels)
    against CPU (f32, plain versions), on WIDE_PARITY_ROWS sequences through
    embed_sequences, as it is and through `quantize_esm2_int8_tree` (the
    int8 hub: its fc1 rows, 20480 wide, go through the GELU->int8 kernel):
    mean embedding cosine of each."""
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    seqs = sample_seqs(WIDE_PARITY_ROWS, np.random.RandomState(4))
    parity = {}
    for name, quant, tol in (("bf16", False, 0.999), ("int8", True, 0.99)):
        weights = esm2.quantize_esm2_int8_tree(state) if quant else state
        outs = []
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            model = SequenceEncoder(cfg2, 1024, proj_type="mlp", quant_int8=quant,
                                    device=device, dtype=dtype)
            model.load_state_dict(weights)
            outs.append(OneProtEmbedder(OneProtModel({"sequence": model}),
                                        buckets=BUCKETS).embed_sequences(seqs))
            del model
        parity[name] = mean_cosine(*outs)
        print(f"  15B-width {name} hub at 2 layers, card vs CPU, {WIDE_PARITY_ROWS} "
              f"sequences: mean cosine {parity[name]:.6f} (gate >= {tol})",
              flush=True)
        require(parity[name] >= tol, f"15B-width {name} parity {parity[name]} < {tol}")
    return parity


def mean_cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return float(np.mean(np.sum(a * b, axis=-1)))


# ---------------------------------------------------------------------------
# the text path: BERT at BiomedBERT-base width through #1-#3 without rotary


def sample_texts(n: int, rng) -> list:
    """n texts of one-token words of the tiny WordPiece vocabulary (whole
    words, letters and digits), [CLS] and [SEP] included: log-normal token
    counts around TEXT_MEDIAN_TOKENS, clipped to [8, TEXT_MAX_TOKENS]."""
    lens = np.clip(rng.lognormal(np.log(TEXT_MEDIAN_TOKENS), TEXT_SIGMA, n),
                   8, TEXT_MAX_TOKENS).astype(int)
    return [" ".join(rng.choice(TEXT_WORDS, n_tok - 2)) for n_tok in lens]


def text_attention_case(what, B, L, gen, lens=None, seg=None):
    """q, k, v [B, L, 12*64] bf16 and the side inputs of a BERT layer: the
    key bias (-1e9 past each row's length, or on a packed row's padding)
    and the segment ids of a packed row; no rotary tables."""
    H, D = TEXT_HEADS, 64
    q, k, v = (torch.randn(B, L, H * D, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    if seg is None:
        valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    else:
        seg = torch.as_tensor(seg, device="cuda", dtype=torch.int32)
        valid = seg >= 0
    bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
    side = dict(bias=bias, rope_cos=None, rope_sin=None, segment_ids=seg)
    return q, k, v, side, valid, f"{what}: B={B} L={L} H={H} D={D}"


def one_launch(launcher, fn):
    """fn()'s result, after checking that it launched `launcher` once."""
    before = launcher.launches
    out = fn()
    require(launcher.launches == before + 1, f"{launcher.__name__}: "
            f"{launcher.launches - before} launches for one call")
    return out


def packed_text_segments(rng):
    """Text-side segment ids [ROWS, ROW_LEN] of a packed seq<->text batch
    as `pack_stream` lays it out (the text CLI phase's lengths)."""
    pairs = []
    while len(pairs) < 200:
        n = int(np.clip(rng.lognormal(np.log(290.0), 0.65), 30, 1022)) + 2
        t = len(sample_texts(1, rng)[0].split()) + 2
        pairs.append((np.zeros(n, np.int32), np.zeros(t, np.int32)))
    batch = next(packing.pack_stream(iter(pairs), ROW_LEN, ROWS, SLOTS))
    return batch["seg_b"]


def check_flash_text(gen, rows: list) -> dict:
    """#1-#3 without rotary at the text path's shapes, each against its
    plain version (out and lse; dq with its prologue, dk and dv, also
    against the whole plain backward) with exact launches, and timed
    beside SDPA with its bound: #1 at embed_texts' B=32 L=512 with rows
    padded 0-75%; #1-#3 at the LoRA text step's B=16 L=512 with that bias;
    #1-#3 on the text rows of a packed batch (bias on the padding and the
    segment ids). The cases go into the three kernels' rows under
    `text_cases`."""
    rng = np.random.RandomState(TEXT_SEED)
    serve_lens = torch.from_numpy(
        rng.randint(TEXT_L // 4, TEXT_L + 1, size=32)).cuda()
    train_lens = torch.from_numpy(
        rng.randint(TEXT_L // 4, TEXT_L + 1, size=16)).cuda()
    cases = [text_attention_case("serving", 32, TEXT_L, gen, serve_lens),
             text_attention_case("LoRA step", 16, TEXT_L, gen, train_lens),
             text_attention_case("packed text rows", ROWS, ROW_LEN, gen,
                                 seg=packed_text_segments(rng))]
    fwd, dq_row, dkv_row = rows
    for row in rows:
        row["text_cases"] = []
    H = TEXT_HEADS
    worst = {"fwd": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for i, (q, k, v, side, valid, what) in enumerate(cases):
        out, lse = one_launch(flash_mha.flash_mha_cuda, lambda: flash_mha.flash_mha_cuda(
            q, k, v, H, **side))
        ref, ref_lse = flash_mha.mha_attention_plain(q, k, v, H, **side)
        torch.cuda.synchronize()
        require(torch.isfinite(out.float()).all().item(), f"{what}: non-finite")
        rel = ((out.float() - ref.float()).abs().max()
               / ref.float().abs().max().clamp_min(1e-6)).item()
        lse_err = (lse - ref_lse).abs()[valid[:, None, :].expand_as(lse)].max().item()
        require(rel <= FLASH_REL_TOL, f"#1 {what}: rel err {rel}")
        require(lse_err <= 5e-2, f"#1 {what}: lse err {lse_err}")
        worst["fwd"], worst["lse"] = max(worst["fwd"], rel), max(worst["lse"],
                                                                 lse_err)
        timing = time_flash_fwd(what, q, k, v, H, side)
        timing["plain_ms"] = time_ms(lambda: flash_mha.mha_attention_plain(
            q, k, v, H, **side), iters=3)
        timing.update(max_rel_err=rel, lse_max_abs_err=lse_err)
        fwd["text_cases"].append(timing)
        if i == 0:  # serving runs the forward only
            continue
        dout = (torch.randn(q.shape, device="cuda", generator=gen)
                * valid[..., None]).to(torch.bfloat16)
        dq, q_r, delta = one_launch(
            flash_mha.flash_mha_bwd_dq_cuda, lambda: flash_mha.flash_mha_bwd_dq_cuda(
                q, k, v, out, lse, dout, H, **side))
        dk, dv = one_launch(
            flash_mha.flash_mha_bwd_dkv_cuda, lambda: flash_mha.flash_mha_bwd_dkv_cuda(
                q_r, k, v, dout, lse, delta, H, **side))
        whole = flash_mha.mha_attention_bwd_plain(q, k, v, out, lse, dout, H,
                                                  **side)
        own_dq, own_qr, _ = flash_mha.flash_mha_bwd_dq_plain(
            q, k, v, out, lse, dout, H, **side)
        own_dkv = flash_mha.flash_mha_bwd_dkv_plain(q_r, k, v, dout, lse,
                                                    delta, H, **side)
        torch.cuda.synchronize()
        require(torch.equal(q_r, own_qr), f"#2 {what}: q_r")
        errs = {}
        for name, got, refs in (("dq", dq, (whole[0], own_dq)),
                                ("dk", dk, (whole[1], own_dkv[0])),
                                ("dv", dv, (whole[2], own_dkv[1]))):
            require(torch.isfinite(got.float()).all().item(),
                    f"{name} {what}: non-finite")
            errs[name] = max(((got.float() - r.float()).abs().max()
                              / r.float().abs().max().clamp_min(1e-6)).item()
                             for r in refs)
            require(errs[name] <= FLASH_REL_TOL, f"{name} {what}: rel err "
                    f"{errs[name]}")
            worst[name] = max(worst[name], errs[name])
        print(f"  no-rotary backward {what}: max rel err " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items()), flush=True)
        del whole, own_dq, own_qr, own_dkv, dq, dk, dv
        timing = time_flash_bwd(what, q, k, v, out, lse, dout, H, side, q_r,
                                delta)
        timing["max_rel_err"] = errs
        dq_row["text_cases"].append(timing)
        dkv_row["text_cases"].append(timing)
    del cases
    torch.cuda.empty_cache()
    return worst


class MemoryTexts(TextDataset):
    """The package's TextDataset with its protein sequences in memory (the
    card's host has no h5py): ids and texts from the split's CSV, as the
    package reads them, sequences from `records`."""

    def __init__(self, records: dict, **kwargs):
        super().__init__(**kwargs)
        self.records = records

    def read_seq(self, seq_id: str):
        return self.records.get(seq_id)


def text_records(root: str, rng) -> dict:
    """TRAINER_PAIRS train and TRAINER_VAL_PAIRS val and test seq<->text
    pairs: sequences as `struct_token_records` draws their lengths, texts
    as `sample_texts`; each split's (id, text) CSV is written to `root`."""
    records = {}
    for split, n in (("train", TRAINER_PAIRS), ("val", TRAINER_VAL_PAIRS),
                     ("test", TRAINER_VAL_PAIRS)):
        ids = [f"{split}_{i:05d}" for i in range(n)]
        lens = np.clip(rng.lognormal(np.log(290.0), 0.65, n), 30, 1022)
        texts = sample_texts(n, rng)
        for sid, n_res in zip(ids, lens.astype(int)):
            records[sid] = "".join(rng.choice(list(AAS), n_res))
        with open(os.path.join(root, f"{split}_text.csv"), "w") as f:
            f.write("".join(f"{sid},{t}\n" for sid, t in zip(ids, texts)))
    return records


def text_serving(smi: str, launches: dict):
    """embed_texts at BiomedBERT-base width (bf16, random weights from a
    seed), 3 requests of 32 texts, then one top-10 retrieval; fills
    launches["text_serve"]. Returns (numbers, the tower's state)."""
    enc = create_text_encoder(TEXT_MODEL)
    require((enc.config.num_layers, enc.config.hidden_size,
             enc.config.num_heads) == (TEXT_LAYERS, 768, TEXT_HEADS),
            f"text tower {enc.config}")
    bert.init_bert_weights_(enc, torch.Generator(device="cuda").manual_seed(
        TEXT_SEED))
    embedder = OneProtEmbedder(OneProtModel({"text": enc}))
    rng = np.random.RandomState(TEXT_SEED)
    requests = [sample_texts(32, rng) for _ in range(TEXT_REQUESTS)]
    tok = embedder.text_tok
    lens = [len(tok.encode_ids(t)) for r in requests for t in r]
    buckets = [pick_bucket(max(len(t) + 2 for t in r), embedder.buckets, 512)
               for r in requests]
    embedder.embed_texts(requests[0][:2])  # warm-up: cuBLAS handles, caches
    torch.cuda.synchronize()
    reset_launches()
    feats, secs = [], []
    scale = 1.0 / 0.07
    for req in requests:
        t = time.time()
        feats.append(embedder.embed_texts(req))
        secs.append(time.time() - t)
        f = feats[-1]
        require(f.shape == (len(req), 1024) and bool(np.isfinite(f).all()),
                f"text embeddings {f.shape}")
        norms = np.linalg.norm(f, axis=-1)
        require(bool(np.all(np.abs(norms / scale - 1.0) <= 1e-2)),
                f"text norms {norms.min()}..{norms.max()}, want {scale}")
    launches["text_serve"] = read_launches()
    none = {name: 0 for name in LAUNCHERS}
    want = {**none, "flash_mha_fwd": TEXT_LAYERS * len(requests)}
    require(launches["text_serve"] == want,
            f"text serving launches {launches['text_serve']}, want {want}")
    require(not any(PLAIN_CALLS.values()),
            f"text serving: plain versions ran on the card: {PLAIN_CALLS}")
    feats = np.concatenate(feats)
    check_retrieval(embedder, feats / scale, rng, "text tower")
    n = len(feats)
    out = {"texts": n, "requests": len(requests),
           "texts_per_s": n / sum(secs), "request_ms": [s * 1e3 for s in secs],
           "tokens": {"median": float(np.median(lens)), "max": int(max(lens)),
                      "min": int(min(lens))},
           "buckets": buckets}
    print(f"  text tower (bert_base, 12 x 768, bf16): {n} texts in "
          f"{sum(secs):.3f} s = {out['texts_per_s']:.1f} texts/s (requests: "
          + ", ".join(f"{s * 1e3:.1f} ms" for s in secs)
          + f"); tokens median {np.median(lens):.0f}, max {max(lens)}; buckets "
          f"by characters + 2: {buckets}; launches {launches['text_serve']}; "
          f"{smi}", flush=True)
    state = first_layers(enc.state_dict(), 2)
    del embedder, enc
    torch.cuda.empty_cache()

    # 2 layers of the same weights, card (bf16, kernels) vs CPU (f32, plain)
    cfg2 = dataclasses.replace(bert.resolve_bert_config(TEXT_MODEL),
                               num_layers=2)
    texts = requests[0][:8]
    embs = []
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = TextEncoder(cfg2, 1024, device=device, dtype=dtype)
        model.load_state_dict(state)
        embs.append(OneProtEmbedder(OneProtModel({"text": model})).embed_texts(
            texts))
    out["parity_mean_cosine"] = mean_cosine(*embs)
    out["parity_min_cosine"] = float(np.min(np.sum(
        embs[0] * embs[1], -1) / np.linalg.norm(embs[0], axis=-1)
        / np.linalg.norm(embs[1], axis=-1)))
    print(f"  text tower at 2 layers, card vs CPU: mean cosine "
          f"{out['parity_mean_cosine']:.6f}, least {out['parity_min_cosine']:.6f} "
          f"(gate >= {TEXT_COS})", flush=True)
    require(out["parity_min_cosine"] >= TEXT_COS,
            f"text parity {out['parity_min_cosine']} < {TEXT_COS}")
    return out


def text_epochs(probe: "TrainerProbe",
                backbones=("sequence", "text")) -> list:
    """Per epoch of a CLI or trainer run: batches, pairs/s (also per
    modality: its pairs over its steps' walls), the batch walls and their
    split, the caches' hit rates, the backbone forwards of `backbones`,
    the validation's wall and the launches of both."""
    marks, out = probe.marks, []
    for i, m in enumerate(marks):
        if m["kind"] != "epoch":
            continue
        v0, v1 = marks[i + 1], marks[i + 2]
        require(v0["kind"] == "val start" and v1["kind"] == "val end",
                f"epoch {m['epoch']}: marks {marks[i:i + 3]}")
        nb = v0["steps"] - m["steps"]
        hits, misses = v0["hits"] - m["hits"], v0["misses"] - m["misses"]
        vh, vm = v1["hits"] - v0["hits"], v1["misses"] - v0["misses"]
        walls, split = probe.batch_split(m["steps"], v0["steps"], m["t"])
        train_s = v0["t"] - m["t"]
        pairs = sum(probe.pairs[m["steps"]:v0["steps"]])
        encodes = lambda a, b: {k: b["encodes"].get(k, 0) - a["encodes"].get(k, 0)
                                for k in backbones}
        by_mod = {}
        for j in range(m["steps"], v0["steps"]):
            mod = probe.step_modalities[j]
            wall = walls[j - m["steps"]] / 1e3
            got = by_mod.setdefault(mod, {"steps": 0, "pairs": 0, "s": 0.0})
            got["steps"] += 1
            got["pairs"] += probe.pairs[j]
            got["s"] += wall
        for got in by_mod.values():
            got["pairs_per_s"] = got["pairs"] / max(got["s"], 1e-9)
        out.append({
            "epoch": m["epoch"], "batches": nb, "pairs": pairs,
            "pairs_per_s": pairs / train_s, "train_s": train_s,
            "by_modality": by_mod,
            "median_batch_ms": float(np.median(walls)),
            "median_split_ms": split,
            "cache_hit_rate": hits / max(hits + misses, 1),
            "val_cache_hit_rate": vh / max(vh + vm, 1),
            "val_s": v1["t"] - v0["t"],
            "encodes": encodes(m, v0), "val_encodes": encodes(v0, v1),
            "launches": delta(m["launches"], v0["launches"]),
            "val_launches": delta(v0["launches"], v1["launches"])})
    return out


def text_cli_phase(smi: str, launches: dict) -> dict:
    """configs/experiment/seq_text.yaml through `cli.train.main` at
    ESM2-650M + BiomedBERT-base width (bf16, random weights from `seed`),
    on text_records held in memory: run 1 as shipped (CLIP, frozen text
    tower: the fully cached steps) 2 epochs and the test split; run 2 with
    a LoRA text tower and SigLIP, 1 epoch (`train_step_cached`: BERT
    forward and backward through #1-#3); run 3 as run 2 on packed rows
    (`train_step_packed_cached`), TEXT_PACKED_BATCHES batches. Fills
    launches["text_cli"] with the three runs' launches."""
    none = {name: 0 for name in LAUNCHERS}
    hub_l = N_LAYERS
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_text_cli_") as root:
        CliDataModule.RECORDS = {"text": text_records(
            root, np.random.RandomState(TEXT_SEED))}
        register_target_alias(CLI_DATA_TARGET, f"{__name__}.CliDataModule")
        base = list(TEXT_CLI_BASE) + [f"paths.data_dir={root}"]
        runs = {"clip": ["trainer.max_epochs=2", "test=true"],
                "lora_siglip": ["trainer.max_epochs=1", "test=false",
                                *TEXT_LORA_SIGLIP],
                "packed": ["trainer.max_epochs=1", "test=false",
                           *TEXT_LORA_SIGLIP, "data.pack_sequences=true",
                           f"trainer.limit_train_batches={TEXT_PACKED_BATCHES}",
                           f"trainer.limit_val_batches={TEXT_PACKED_VAL}"]}
        probe = CliProbe()
        metrics = {}
        try:
            torch.cuda.synchronize()
            reset_launches()
            for name, extra in runs.items():
                metrics[name] = probe.main(base + extra + [
                    f"hydra.run.dir={root}/{name}"])
            launches["text_cli"] = read_launches()
            plain = dict(PLAIN_CALLS)
        finally:
            probe.close()
            TARGET_ALIASES.pop(CLI_DATA_TARGET, None)
            CliDataModule.RECORDS = {}
    require(not any(plain.values()), f"text cli: plain versions ran on the "
            f"card: {plain}")
    clip, lora, packed = probe.runs
    total = dict(none)
    n_val = TRAINER_VAL_PAIRS // TEXT_VAL_BATCH
    n_test = -(-TRAINER_VAL_PAIRS // TEXT_TEST_BATCH)
    for name, run in zip(runs, probe.runs):
        epochs = text_epochs(run["probe"])
        module = run["module"]
        require(module.step == sum(e["batches"] for e in epochs)
                == metrics[name]["train/steps"], f"text cli {name} steps")
        losses = torch.stack(run["probe"].losses).float().cpu().numpy()
        require(bool(np.isfinite(losses).all()), f"text cli {name} losses")
        for e in epochs:
            nb, cold = e["batches"], e["epoch"] == 0
            enc, val_enc = e["encodes"], e["val_encodes"]
            if name == "clip":
                # a batch that misses a cache runs that backbone's forward
                # (33 or 12 #1): in epoch 1 every batch misses in both. The
                # cache keys padded rows, so a pair whose batch pads it to
                # another bucket in epoch 2 misses again; the validation's
                # batches repeat and hit
                nv = n_val
                if cold:
                    require(enc == {"sequence": nb, "text": nb}
                            and val_enc == {"sequence": nv, "text": nv},
                            f"text cli epoch 1 forwards {enc}, {val_enc}")
                else:
                    require(val_enc == {"sequence": 0, "text": 0}
                            and e["val_cache_hit_rate"] == 1.0,
                            f"text cli epoch 2 validation {val_enc}, hit rate "
                            f"{e['val_cache_hit_rate']}")
                want = {**none, "flash_mha_fwd": hub_l * enc["sequence"]
                        + TEXT_LAYERS * enc["text"]}
                want_val = {**none, "flash_mha_fwd": hub_l * val_enc["sequence"]
                            + TEXT_LAYERS * val_enc["text"]}
            else:
                # the hub misses its cache once a batch; BERT trains
                nv = TEXT_PACKED_VAL if name == "packed" else n_val
                require(enc["sequence"] == nb and val_enc["sequence"] == nv
                        and enc["text"] == val_enc["text"] == 0,
                        f"text cli {name} forwards {enc}, {val_enc}")
                want = {**none, "flash_mha_fwd": (hub_l + TEXT_LAYERS) * nb,
                        "flash_mha_bwd_dq": TEXT_LAYERS * nb,
                        "flash_mha_bwd_dkv": TEXT_LAYERS * nb}
                want_val = {**none, "flash_mha_fwd": (hub_l + TEXT_LAYERS) * nv}
            require(e["launches"] == want, f"text cli {name} epoch "
                    f"{e['epoch']} launches {e['launches']}, want {want}")
            require(e["val_launches"] == want_val, f"text cli {name} "
                    f"validation {e['epoch']} launches {e['val_launches']}, "
                    f"want {want_val}")
            for k in none:
                total[k] += e["launches"][k] + e["val_launches"][k]
        if "test_launches" in run:
            want_test = {**none, "flash_mha_fwd": (hub_l + TEXT_LAYERS) * n_test}
            require(run["test_launches"] == want_test, f"text cli test "
                    f"launches {run['test_launches']}, want {want_test}")
            for k in none:
                total[k] += run["test_launches"][k]
        finite = [v for k, v in metrics[name].items()
                  if k.startswith(("val/", "test/"))]
        require(len(finite) > 5 and bool(np.isfinite(finite).all()),
                f"text cli {name} metrics {metrics[name]}")
        out[name] = {
            "model_build_s": run["build_s"], "fit_s": run["fit_s"],
            "main_s": run["main_s"], "steps": module.step,
            "loss_first_last": [float(losses[0]), float(losses[-1])],
            "epochs": [{k: v for k, v in e.items()
                        if k not in ("launches", "val_launches")}
                       for e in epochs],
            "launches_per_epoch": [e["launches"] for e in epochs],
            "checkpoint_saves": run["probe"].saves,
            "val_loss": metrics[name]["val/loss"]}
        if "test_s" in run:
            out[name]["test_s"] = run["test_s"]
            out[name]["test_loss"] = metrics[name]["test/loss"]
        print(f"  text cli {name}: build {run['build_s']:.2f} s, fit "
              f"{run['fit_s']:.2f} s, " + "; ".join(
                  f"epoch {e['epoch']}: {e['batches']} batches, "
                  f"{e['pairs_per_s']:.1f} pairs/s, median batch "
                  f"{e['median_batch_ms']:.1f} ms (loader "
                  f"{e['median_split_ms']['loader']:.1f}, lookup "
                  f"{e['median_split_ms']['lookup']:.1f}, step "
                  f"{e['median_split_ms']['step']:.1f}), hit rate "
                  f"{e['cache_hit_rate']:.3f} / val "
                  f"{e['val_cache_hit_rate']:.3f}, backbone forwards "
                  f"{e['encodes']} / val {e['val_encodes']}, validation "
                  f"{e['val_s']:.2f} s"
                  for e in epochs)
              + (f"; test {run['test_s']:.2f} s" if "test_s" in run else "")
              + "; checkpoints " + ", ".join(
                  f"{s['name']} {s['s']:.2f} s" for s in run["probe"].saves)
              + f"; loss {losses[0]:.4f} -> {losses[-1]:.4f}; val/loss "
              f"{metrics[name]['val/loss']:.4f}; {smi}", flush=True)
    require(launches["text_cli"] == total, f"text cli launches "
            f"{launches['text_cli']}, want {total}")
    loaded = [m for m in sys.modules if m.split(".")[0] in (
        "yaml", "h5py", "jax", "oneprot_tpu", "pandas")]
    require(not loaded, f"text cli: modules loaded {loaded}")
    out["launches"] = launches["text_cli"]
    return out


def text_parity() -> dict:
    """2 hub + 2 BERT layers of full width, LoRA text tower (dropout 0),
    SigLIP + L1, TEXT_PARITY_STEPS `train_step_cached` steps at Adam 1e-3
    on fresh batches
    of TEXT_PARITY_BATCH pairs, each side's hub pooled features its own:
    card (bf16, kernels) against CPU (f32, plain versions)."""
    gen = torch.Generator(device="cpu").manual_seed(TEXT_SEED)
    hub_cfg = dataclasses.replace(esm2.ESM2_SIZES["esm2_t33_650M"], num_layers=2)
    text_cfg = dataclasses.replace(bert.resolve_bert_config(TEXT_MODEL),
                                   num_layers=2)
    lora = esm2.LoraConfig(8, 8.0, 0.0)  # text.yaml's r and alpha

    def module_on(device, dtype):
        m = OneProtModule(
            {"sequence": SequenceEncoder(hub_cfg, 1024, proj_type="mlp",
                                         device=device, dtype=dtype),
             "text": TextEncoder(text_cfg, 1024, lora=lora, device=device,
                                 dtype=dtype)},
            optimizer=lambda: adam(1e-3), loss_fn="SigLIP",
            use_l1_regularization=True)
        return m

    cpu = module_on("cpu", torch.float32)
    esm2.init_esm2_weights_(cpu.encoders["sequence"], gen)
    bert.init_bert_weights_(cpu.encoders["text"], gen)
    state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    cpu.init()
    card = module_on("cuda", torch.bfloat16)
    card.model.load_state_dict(state)
    card.init()
    rng = np.random.RandomState(TEXT_SEED + 1)
    seq_tok, text_tok = esm2_tokenizer(), resolve_text_tokenizer("tiny")
    losses = {"cuda": [], "cpu": []}
    for _ in range(TEXT_PARITY_STEPS):
        seqs = sample_seqs(TEXT_PARITY_BATCH, rng)
        texts = sample_texts(TEXT_PARITY_BATCH, rng)
        seq_ids = seq_tok(seqs, max_length=1024, padding=pick_bucket(
            max(len(s) + 2 for s in seqs), DATA_BUCKETS, 1024))
        longest = max(len(text_tok.encode_ids(t, 512)) for t in texts)
        text_ids = text_tok(texts, max_length=512, padding=pick_bucket(
            longest, DATA_BUCKETS, 512))
        for device, m in (("cuda", card), ("cpu", cpu)):
            pooled = m.encode_pooled("sequence", seq_ids)
            loss, _ = m.train_step_cached("text", pooled, text_ids)
            losses[device].append(loss.item())
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    trainable = lambda m: flat(m.opt.params)
    out = {"loss_card": losses["cuda"], "loss_cpu": losses["cpu"],
           "loss_rel_diff": rel,
           "param_cosine": cosine(trainable(card), trainable(cpu))}
    print(f"  LoRA text + SigLIP, {TEXT_PARITY_STEPS} steps, card vs CPU: "
          f"losses " + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(
              losses["cuda"], losses["cpu"]))
          + f" (rel diff max {max(rel):.2e}, gate <= 2e-2 each); trainable "
          f"parameters' cosine {out['param_cosine']:.6f} (gate >= 0.99)",
          flush=True)
    require(max(rel) <= 2e-2, f"text parity losses {rel}")
    require(out["param_cosine"] >= 0.99, f"text parity parameters {out}")
    return out


# ---------------------------------------------------------------------------
# the f32 instances of #1-#3, #8 at heads of 16, the graph tower, seq<->msa
# and seqsim training, the shipped default train.yaml and the f32 debug
# experiments


def f32_case(B, L, H, D, gen, rotary, n_seg, shortest=2):
    """f32 q, k, v [B, L, H*D], the side inputs (a key bias, rotary tables,
    n_seg contiguous segments a row with padding as its own id, or with
    n_seg = "real" the segment ids of a real packed batch,
    `packed_struct_segments`, at B = ROWS and L = ROW_LEN) and an upstream
    gradient zero on padding rows; the valid positions [B, L]. Rows hold
    L // shortest to L real tokens (n_seg = "real": the batch's)."""
    dev = "cuda"
    q, k, v = (torch.randn(B, L, H * D, device=dev, generator=gen)
               for _ in range(3))
    lens = torch.randint(L // shortest, L + 1, (B,), device=dev, generator=gen)
    valid = torch.arange(L, device=dev)[None, :] < lens[:, None]
    seg = None
    if n_seg == "real":
        seg = torch.from_numpy(packed_struct_segments()).to(dev, torch.int32)
        valid = seg >= 0
    elif n_seg:
        seg = torch.where(valid, (torch.arange(L, device=dev)[None, :] * n_seg
                                  // L).repeat(B, 1), -1).to(torch.int32)
    side = {"bias": ((1.0 - valid.float()) * -1e9)[:, None, None, :]}
    if rotary:
        side["rope_cos"], side["rope_sin"] = esm2.rotary_cos_sin(L, D, device=dev)
    if seg is not None:
        side["segment_ids"] = seg
    dout = torch.randn(B, L, H * D, device=dev, generator=gen) * valid[..., None]
    return q, k, v, side, dout, valid


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


F32_NAMES = ("flash_mha_fwd_f32", "flash_mha_bwd_dq_f32", "flash_mha_bwd_dkv_f32")
# (what, B, L, H, D, rotary, segments a row, rows' shortest fraction): the
# debug hubs' packed rows (ESM2-8M: 320 / 20 = heads of 16; train_packed's
# 16 x 1024), bert_tiny's heads of 64 (key bias, no rotary) at a text
# bucket, ragged packed rows: L=200 off the tiled kernels' 32- and 64-row
# tiles, rows of 50-200 tokens, so whole tiles at their tails hold padding
# only, and the segment ids of train_packed's real packed batch (proteins
# of log-normal lengths, their ends anywhere in a tile)
F32_CASES = (("debug hub, packed", 16, 1024, 20, 16, True, 16, 2),
             ("bert_tiny", 16, 512, 2, 64, False, 0, 2),
             ("ragged packed rows", 8, 200, 20, 16, True, 3, 4),
             ("debug hub, real packed batch", ROWS, ROW_LEN, 20, 16, True,
              "real", 2))
# the tiled f32 kernels (#1-#3) by library: every head-dim instance
# D=8..64 must build without spilling
F32_TILED = {"flash_mha_fwd_f32": "fwd_tiled", "flash_mha_bwd_dq_f32": "dq_tiled",
             "flash_mha_bwd_dkv_f32": "dkv_tiled"}


def f32_ptxas() -> dict:
    """Registers and spill bytes of each head-dim instance of the tiled f32
    kernels, from the build's -Xptxas -v; gated: all eight instances D=8..64
    of each, none spilling."""
    found = {}
    for name, kernel in F32_TILED.items():
        found[name] = {}
        for instance, line in ptxas_report(_build.build_log(name)):
            d = re.fullmatch(kernel + r"<(\d+)>", instance)
            if d is not None:
                found[name][int(d.group(1))] = {
                    "registers": int(re.search(r"Used (\d+) registers",
                                               line).group(1)),
                    "spill_bytes": sum(int(n) for n in re.findall(
                        r"(\d+) bytes spill", line))}
        print(f"  {name} ({kernel}) ptxas: " + ", ".join(
            f"D={d} {r['registers']} registers, {r['spill_bytes']} bytes spill"
            for d, r in sorted(found[name].items())), flush=True)
        require(sorted(found[name]) == list(range(8, 72, 8)),
                f"{name}: ptxas instances {sorted(found[name])}")
        require(not any(r["spill_bytes"] for r in found[name].values()),
                f"{name} spills: {found[name]}")
    return found


def check_flash_f32(gen) -> list:
    """The f32 forward (#1), dq (#2, its prologue's q_r and delta too) and
    dk/dv (#3) kernels, one launch each, against their own plain versions
    in f32 on the card (max rel err <= 1e-4, lse within 1e-5 on the real
    rows), dq, dk and dv also against the whole plain backward; each timed
    beside its plain version, SDPA's f32 forward or backward (both passes:
    forward + backward minus forward) on the same inputs with a dense f32
    mask, and its bound (f32 67 TFLOP/s over the logit pairs of equal
    segment ids, or the bytes at 3.35 TB/s); #2 + #3 printed beside SDPA's
    f32 backward on each case. Returns the three rows; the first case is
    each row, the others its cases; each row carries its instances'
    registers and spills (`f32_ptxas`)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    found = {n: [] for n in F32_NAMES}
    ptxas = f32_ptxas()
    for what, B, L, H, D, rotary, n_seg, shortest in F32_CASES:
        q, k, v, side, dout, valid = f32_case(B, L, H, D, gen, rotary, n_seg,
                                              shortest)
        seg = side.get("segment_ids")
        before = [LAUNCHERS[n].launches for n in F32_NAMES]
        out, lse = flash_mha.flash_mha_cuda(q, k, v, H, **side)
        dq, q_r, delta = flash_mha.flash_mha_bwd_dq_cuda(q, k, v, out, lse,
                                                         dout, H, **side)
        dk, dv = flash_mha.flash_mha_bwd_dkv_cuda(q_r, k, v, dout, lse, delta,
                                                  H, **side)
        torch.cuda.synchronize()
        require([LAUNCHERS[n].launches - b for n, b in zip(F32_NAMES, before)]
                == [1, 1, 1], f"f32 {what}: one launch each")
        ref, ref_lse = flash_mha.mha_attention_plain(q, k, v, H, **side)
        ref_dq, ref_qr, ref_delta = flash_mha.flash_mha_bwd_dq_plain(
            q, k, v, out, lse, dout, H, **side)
        ref_dk, ref_dv = flash_mha.flash_mha_bwd_dkv_plain(
            q_r, k, v, dout, lse, delta, H, **side)
        whole = flash_mha.mha_attention_bwd_plain(q, k, v, out, lse, dout, H,
                                                  **side)
        rows = valid[:, None, :].expand_as(lse)
        lse_err = (lse - ref_lse).abs()[rows].max().item()
        errs = {"flash_mha_fwd_f32": [rel_err(out, ref)],
                "flash_mha_bwd_dq_f32": [rel_err(dq, ref_dq), rel_err(q_r, ref_qr),
                                         rel_err(delta, ref_delta),
                                         rel_err(dq, whole[0])],
                "flash_mha_bwd_dkv_f32": [rel_err(dk, ref_dk), rel_err(dv, ref_dv),
                                          rel_err(dk, whole[1]),
                                          rel_err(dv, whole[2])]}
        abs_errs = {"flash_mha_fwd_f32": (out - ref).abs().max().item(),
                    "flash_mha_bwd_dq_f32": (dq - ref_dq).abs().max().item(),
                    "flash_mha_bwd_dkv_f32": max((dk - ref_dk).abs().max().item(),
                                                 (dv - ref_dv).abs().max().item())}
        for name, e in errs.items():
            require(max(e) <= F32_REL_TOL and all(np.isfinite(e)),
                    f"f32 {what} {name}: max rel errs {e} > {F32_REL_TOL}")
        require(lse_err <= F32_LSE_TOL, f"f32 {what}: lse err {lse_err}")
        times = {
            "flash_mha_fwd_f32": time_ms(lambda: flash_mha.flash_mha_cuda(
                q, k, v, H, **side)),
            "flash_mha_bwd_dq_f32": time_ms(lambda: flash_mha.flash_mha_bwd_dq_cuda(
                q, k, v, out, lse, dout, H, **side)),
            "flash_mha_bwd_dkv_f32": time_ms(
                lambda: flash_mha.flash_mha_bwd_dkv_cuda(q_r, k, v, dout, lse,
                                                         delta, H, **side))}
        plains = {
            "flash_mha_fwd_f32": time_ms(lambda: flash_mha.mha_attention_plain(
                q, k, v, H, **side), iters=3),
            "flash_mha_bwd_dq_f32": time_ms(lambda: flash_mha.flash_mha_bwd_dq_plain(
                q, k, v, out, lse, dout, H, **side), iters=3),
            "flash_mha_bwd_dkv_f32": time_ms(
                lambda: flash_mha.flash_mha_bwd_dkv_plain(
                    q_r, k, v, dout, lse, delta, H, **side), iters=3)}
        heads = lambda x: x.view(B, L, H, D).transpose(1, 2)
        qh, kh = heads(q), heads(k)
        if rotary:
            qh = flash_mha.apply_rotary(qh, side["rope_cos"], side["rope_sin"])
            kh = flash_mha.apply_rotary(kh, side["rope_cos"], side["rope_sin"])
        leaves = [x.detach().contiguous().requires_grad_()
                  for x in (qh, kh, heads(v))]
        mask = side["bias"].expand(B, 1, L, L)
        if seg is not None:
            mask = mask + flash_mha.packed_segment_bias(
                seg, mask_value=flash_mha.SEG_MASK)
        mask = mask.contiguous()
        do_h = heads(dout).contiguous()
        lib_fwd = time_ms(lambda: sdpa(*leaves, attn_mask=mask))
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(*leaves, attn_mask=mask), leaves, do_h))
        lib_bwd = lib_fwd_bwd - lib_fwd
        libs = {"flash_mha_fwd_f32": lib_fwd, "flash_mha_bwd_dq_f32": lib_bwd,
                "flash_mha_bwd_dkv_f32": lib_bwd}
        pairs = needed_pairs(seg, B, L) * H
        x = B * L * H * D * 4  # one [B, L, H*D] f32 tensor
        side_bytes = B * L * 4 * (1 + (seg is not None)) + (
            2 * L * D * 4 if rotary else 0)
        stat = B * H * L * 4
        bounds = {
            "flash_mha_fwd_f32": bound_ms(4 * x + side_bytes + stat,
                                          4.0 * D * pairs, F32_FLOPS),
            "flash_mha_bwd_dq_f32": bound_ms(7 * x + side_bytes + 2 * stat,
                                             6.0 * D * pairs, F32_FLOPS),
            "flash_mha_bwd_dkv_f32": bound_ms(6 * x + side_bytes + 2 * stat,
                                              8.0 * D * pairs, F32_FLOPS)}
        shape = (f"B={B} L={L} H={H} D={D} f32"
                 + (", real packed batch" if n_seg == "real" else
                    f", {n_seg} segments a row" if n_seg else "")
                 + ("" if rotary else ", no rotary"))
        for name in F32_NAMES:
            b_ms, b_by = bounds[name]
            found[name].append({
                "shape": shape, "max_rel_err": max(errs[name]),
                "max_abs_err": abs_errs[name], "ms": times[name],
                "plain_ms": plains[name], "library_ms": libs[name],
                "bound_ms": b_ms, "bound_by": b_by})
            print(f"  {name} {what} ({shape}): max rel err {max(errs[name]):.2e}"
                  f"{f', lse max abs err {lse_err:.2e}' if 'fwd' in name else ''};"
                  f" kernel {times[name]:.4f} ms, plain {plains[name]:.4f} ms, "
                  f"SDPA f32 {libs[name]:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
        pair = times["flash_mha_bwd_dq_f32"] + times["flash_mha_bwd_dkv_f32"]
        print(f"  f32 backward {what}: #2 + #3 {pair:.4f} ms, SDPA f32 backward "
              f"{lib_bwd:.4f} ms (forward + backward {lib_fwd_bwd:.4f} minus "
              f"forward {lib_fwd:.4f}), ratio {pair / lib_bwd:.3f}", flush=True)
        del q, k, v, out, lse, dq, q_r, delta, dk, dv, leaves, mask
        torch.cuda.empty_cache()
    sources = {"flash_mha_fwd_f32": ("flash_mha_fwd_f32.cu", 157),
               "flash_mha_bwd_dq_f32": ("flash_mha_bwd_dq_f32.cu", 512),
               "flash_mha_bwd_dkv_f32": ("flash_mha_bwd_dkv_f32.cu", 619)}
    out_rows = []
    for name in F32_NAMES:
        row, *cases = found[name]
        src, line = sources[name]
        out_rows.append({
            "name": name, "route": "cuda",
            "source": f"oneprot_tpu_torch/kernels/csrc/{src}",
            "replaces": f"oneprot_tpu/kernels/flash_mha.py:{line}",
            **{k: row[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "shape")},
            "cases": cases,
            "ptxas": ptxas[name],
            "note": "the f32 instance (f32 FMA on the CUDA cores; "
                    "register-tiled, 64-row tiles); library_ms: SDPA in f32 "
                    "with a dense f32 mask"
                    + ("" if "fwd" in name else ", its backward (both "
                       "passes) for #2 and #3")})
    return out_rows


def check_tied_row_narrow(gen) -> list:
    """#8 on heads of 16 (the debug MSA tower: 64 wide, 4 heads; depth 4
    at its bucket 128, and the data config's depth 50 at 1024 columns),
    zero-padded to 64 around the one launch, against the plain version at
    the bf16 gate; timed beside the plain version, SDPA on heads of R*16
    and the bound of the unpadded work."""
    cases = []
    for B, R, L, nh, D in ((2, 4, 128, 4, 16), (4, 50, 1024, 4, 16)):
        q, k, v = (torch.randn(B, R, L, nh * D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        bias = torch.zeros(B, 1, 1, L, device="cuda")
        bias[-1, ..., L - L // 3:] = -1e9
        before = tra.tied_row_attention_cuda.launches
        out = tra.tied_row_attention_cuda(q, k, v, nh, col_bias=bias)
        ref = tra.tied_row_attention_plain(q, k, v, nh, col_bias=bias)
        torch.cuda.synchronize()
        require(tra.tied_row_attention_cuda.launches == before + 1,
                "tied-row narrow: one launch")
        rel = rel_err(out, ref)
        shape = f"B={B} R={R} L={L} H={nh} D={D} bf16 (zero-padded to 64)"
        require(rel <= FLASH_REL_TOL and torch.isfinite(out.float()).all().item(),
                f"tied-row {shape}: rel err {rel}")
        kernel = time_ms(lambda: tra.tied_row_attention_cuda(q, k, v, nh,
                                                             col_bias=bias))
        plain = time_ms(lambda: tra.tied_row_attention_plain(
            q, k, v, nh, col_bias=bias), iters=3)
        tied = lambda x: x.view(B, R, L, nh, D).permute(0, 3, 2, 1, 4).reshape(
            B, nh, L, R * D)
        qt, kt, vt = tied(q), tied(k), tied(v)
        library = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias.to(torch.bfloat16),
            scale=tra.tied_scale(D, R)))
        row_bytes = R * nh * D * 2
        b_ms, b_by = bound_ms(4 * B * L * row_bytes + B * L * 4,
                              4.0 * nh * L * L * B * R * D, BF16_FLOPS)
        print(f"  tied-row {shape}: max rel err {rel:.3e}; kernel "
              f"{kernel:.4f} ms, plain {plain:.4f} ms, SDPA {library:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        cases.append({"shape": shape, "max_rel_err": rel,
                      "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                      "ms": kernel, "plain_ms": plain, "library_ms": library,
                      "bound_ms": b_ms, "bound_by": b_by})
    return cases


# the graph towers at configs/model/components/struct_graph.yaml's and
# pocket.yaml's widths (ProNet hidden 128, 4 layers, out 1024; linear head,
# logit scale 1/0.07), K = 24 neighbours, requests of 16 graphs
GRAPH_ENCODER = dict(level="backbone", out_channels=1024, euler_noise=True,
                     data_augment_eachlayer=True, dropout=0.25,
                     hidden_size=128, num_layers=4)
GRAPH_K, GRAPH_BATCH, GRAPH_REQUESTS, GRAPH_SEED = 24, 16, 3, 17
GRAPH_SIZES = (("struct_graph", 1024), ("pocket", 128))
GRAPH_COS = 0.999
GRAPH_PARITY_GRAPHS = 4


def parse_chain(path: str):
    """(sequence, atom names, residue ids, xyz) of chain A of a PDB file, as
    `structure_io` parses it and StructDataset reads it."""
    chain = structure_io.parse_structure_file(path)["A"]
    return (chain.seq1, chain.atom_names, chain.atom_amino_id,
            chain.xyz.astype(np.float64))


def write_structures(root: str, rng, lengths, tag: str) -> list:
    """One synthetic chain a length, written as PDB text to `root` and
    parsed back: [(sequence, atom names, residue ids, xyz), ...]."""
    out = []
    for i, n_res in enumerate(lengths):
        seq = "".join(rng.choice(list(AAS), int(n_res)))
        path = os.path.join(root, f"{tag}_{i:05d}.pdb")
        with open(path, "w") as f:
            f.write(synthetic.backbone_pdb(seq, rng))
        out.append(parse_chain(path))
    return out


def graph_phase(smi: str, launches: dict) -> dict:
    """StructGraphEncoder at struct_graph.yaml's widths on graphs of 1024
    residues, then at pocket.yaml's on 128: synthetic backbones written as
    PDB text, parsed by structure_io, built by protein_to_padded_graph
    (K = 24) and embedded through `OneProtEmbedder.embed_structures`, 3
    requests of 16; graphs/s end to end and for the tower alone, peak
    memory; then card vs CPU in eval mode on the same weights (least
    cosine >= 0.999 over GRAPH_PARITY_GRAPHS graphs). The tower has no
    kernel: no counter may move."""
    out = {}
    rng = np.random.RandomState(GRAPH_SEED)
    none = {name: 0 for name in LAUNCHERS}
    for name, residues in GRAPH_SIZES:
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as root:
            t = time.time()
            structures = write_structures(
                root, rng, [residues] * (GRAPH_REQUESTS * GRAPH_BATCH), name)
            parse_s = time.time() - t
        enc = create_struct_graph_encoder(encoder=dict(GRAPH_ENCODER),
                                          output_dim=1024)
        esm2.init_esm2_weights_(enc, torch.Generator(device="cuda").manual_seed(
            GRAPH_SEED))
        embedder = OneProtEmbedder(OneProtModel({name: enc}))
        kw = dict(modality=name, max_residues=residues, max_neighbors=GRAPH_K,
                  batch_size=GRAPH_BATCH)
        embedder.embed_structures(structures[:2], **kw)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        feats, secs = [], []
        for r in range(GRAPH_REQUESTS):
            t = time.time()
            feats.append(embedder.embed_structures(
                structures[r * GRAPH_BATCH:(r + 1) * GRAPH_BATCH], **kw))
            secs.append(time.time() - t)
        launches[f"{name} serving"] = read_launches()
        require(launches[f"{name} serving"] == none and not any(
            PLAIN_CALLS.values()), f"{name}: launches {launches[name + ' serving']}")
        feats = np.concatenate(feats)
        norms = np.linalg.norm(feats, axis=-1)
        require(feats.shape == (len(structures), 1024)
                and bool(np.isfinite(feats).all())
                and bool(np.all(np.abs(norms * 0.07 - 1.0) <= 1e-3)),
                f"{name} embeddings {feats.shape}, norms {norms.min()}..")
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the tower alone on one built batch, host work excluded
        t = time.time()
        batch = graphs.stack_graphs([graphs.protein_to_padded_graph(
            *s, max_residues=residues, max_neighbors=GRAPH_K)
            for s in structures[:GRAPH_BATCH]])
        build_s = time.time() - t
        graph = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        enc.eval()
        with torch.no_grad():
            tower_ms = time_ms(lambda: enc(graph), iters=5)
        # card vs CPU on the same weights, eval mode
        cpu = create_struct_graph_encoder(encoder=dict(GRAPH_ENCODER),
                                          output_dim=1024, device="cpu").eval()
        cpu.load_state_dict({k: v.cpu() for k, v in enc.state_dict().items()})
        few = {k: v[:GRAPH_PARITY_GRAPHS] for k, v in batch.items()}
        with torch.no_grad():
            got = enc({k: torch.from_numpy(v).cuda() for k, v in few.items()})
            want = cpu({k: torch.from_numpy(v) for k, v in few.items()})
        cos = torch.nn.functional.cosine_similarity(
            got.float().cpu(), want, dim=-1)
        out[name] = {
            "graphs": len(structures), "residues": residues, "k": GRAPH_K,
            "graphs_per_s": len(structures) / sum(secs),
            "request_ms": [x * 1e3 for x in secs],
            "tower_ms_per_batch": tower_ms,
            "tower_graphs_per_s": GRAPH_BATCH / tower_ms * 1e3,
            "host_build_ms_per_batch": build_s * 1e3,
            "pdb_write_parse_s": parse_s, "peak_gib": peak,
            "parity_min_cosine": float(cos.min()),
            "parity_mean_cosine": float(cos.mean())}
        print(f"  {name} (ProNet 128 x 4, out 1024, f32): {len(structures)} "
              f"graphs of {residues} residues, K={GRAPH_K}: "
              f"{out[name]['graphs_per_s']:.1f} graphs/s end to end (requests "
              + ", ".join(f"{x * 1e3:.1f} ms" for x in secs)
              + f"); the tower alone {tower_ms:.2f} ms a batch of "
              f"{GRAPH_BATCH} ({out[name]['tower_graphs_per_s']:.1f} graphs/s), "
              f"host graph build {build_s * 1e3:.1f} ms a batch; PDB write + "
              f"parse {parse_s:.2f} s; peak {peak:.2f} GiB; card vs CPU least "
              f"cosine {out[name]['parity_min_cosine']:.6f} (gate >= "
              f"{GRAPH_COS}); {smi}", flush=True)
        require(out[name]["parity_min_cosine"] >= GRAPH_COS,
                f"{name} parity {out[name]['parity_min_cosine']}")
        del embedder, enc, cpu, graph
        torch.cuda.empty_cache()
    return out


# seq<->msa and seqsim through Trainer.fit: configs/data/modalities/msa.yaml
# (depth 50, batches 16 / 8) and seqsim.yaml (16 / 16), the 650M hub and
# esm_msa1b, one bucket of 1024 so a protein's padded row (the cache's key)
# is the same in every batch
MSA_TRAIN_DEPTH, MSA_TRAIN_HOMOLOGS = 50, 64
MSA_TRAIN_ITEMS, MSA_EVAL_ITEMS = 64, 32
SEQSIM_ITEMS, SEQSIM_EVAL_ITEMS = 64, 32
MSA_TRAIN_SEED = 19


def seqsim_files(root: str, rng, counts: dict) -> None:
    """`{split}_seqsim.txt` (sequences: the ClinVar tables key mutations by
    sequence), `{split}_msa_seqsim.csv` (req_seq, aligned_seq with 5% '-')
    and the two mutation tables, one benign and one pathogenic mutation a
    protein, so each protein's pairs are the same in every epoch."""
    benign, pathogenic = {}, {}
    for split, n in counts.items():
        seqs = sample_seqs(n, rng)
        rows = ["req_seq,aligned_seq"]
        for seq in seqs:
            pos = rng.randint(0, len(seq), 2)
            benign[seq] = [f"{seq[pos[0]]}{pos[0] + 1}{rng.choice(list(AAS))}"]
            pathogenic[seq] = [f"{seq[pos[1]]}{pos[1] + 1}{rng.choice(list(AAS))}"]
            aligned = "".join("-" if rng.rand() < 0.05 else c for c in seq)
            rows.append(f"{seq},{aligned}")
        with open(os.path.join(root, f"{split}_seqsim.txt"), "w") as f:
            f.write("\n".join(seqs) + "\n")
        with open(os.path.join(root, f"{split}_msa_seqsim.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    for name, table in (("benign", benign), ("pathogenic", pathogenic)):
        with open(os.path.join(root, f"clinvar_full_{name}_mutations.json"),
                  "w") as f:
            json.dump(table, f)


def msa_files(root: str, rng, counts: dict,
              homologs: int = MSA_TRAIN_HOMOLOGS) -> None:
    """`write_msas`' synthetic .a3m files (query lengths log-normal around
    290 columns, at most 1022) and `{split}_msa.csv` naming them."""
    for split, n in counts.items():
        sub = os.path.join(root, f"msa_{split}")
        os.makedirs(sub, exist_ok=True)
        paths = write_msas(sub, rng, n, homologs)
        with open(os.path.join(root, f"{split}_msa.csv"), "w") as f:
            f.write("".join(f"{split}_{i:05d},{p}\n"
                            for i, p in enumerate(paths)))


def msa_seqsim_phase(smi: str, launches: dict) -> dict:
    """seq<->msa and seqsim through Trainer.fit: the frozen ESM2-650M hub
    and the frozen esm_msa1b tower (depth 50), both cached
    (`train_step_fully_cached`), 2 epochs. Epoch 1 fills both caches (33 #1
    a hub forward, 12 #8 an MSA forward); epoch 2 and its validation
    launch neither. Fills launches["msa_seqsim"]."""
    hub = create_sequence_encoder(proj_type="mlp")
    esm2.init_esm2_weights_(hub, torch.Generator(device="cuda").manual_seed(21))
    tower = create_msa_encoder()
    msa_transformer.init_msa_weights_(
        tower, torch.Generator(device="cuda").manual_seed(22))
    module = OneProtModule({"sequence": hub, "msa": tower},
                           optimizer=lambda: adam(TRAINER_LR), loss_fn="CLIP",
                           use_l1_regularization=True, use_seqsim=True)
    rng = np.random.RandomState(MSA_TRAIN_SEED)
    counts = {"train": MSA_TRAIN_ITEMS, "val": MSA_EVAL_ITEMS,
              "test": MSA_EVAL_ITEMS}
    none = {name: 0 for name in LAUNCHERS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_msa_train_") as root:
        msa_files(root, rng, counts)
        seqsim_files(root, rng, {"train": SEQSIM_ITEMS, "val": SEQSIM_EVAL_ITEMS,
                                 "test": SEQSIM_EVAL_ITEMS})
        dm = OneProtDataModule(
            modalities={
                "msa": {"dataset": {"data_dir": root, "max_length": 1024,
                                    "msa_depth": MSA_TRAIN_DEPTH},
                        "batch_size": {"train": 16, "val": 8, "test": 8}},
                "seqsim": {"dataset": {"data_dir": root, "max_length": 1024},
                           "batch_size": {"train": 16, "val": 16,
                                          "test": 16}}},
            buckets=[1024], num_workers=4)
        probe = TrainerProbe(module, dm)
        trainer = Trainer(max_epochs=2, accelerator="gpu",
                          cache_frozen_features=True,
                          log_every_n_steps=TRAINER_LOG_EVERY,
                          default_root_dir=os.path.join(root, "run"))
        probe.attach(trainer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            t = time.time()
            metrics = trainer.fit(module, dm)
            probe.mark("end")
            fit_s = time.time() - t
        finally:
            probe.close()
        launches["msa_seqsim"] = read_launches()
    require(not any(PLAIN_CALLS.values()),
            f"msa/seqsim: plain versions ran on the card: {PLAIN_CALLS}")
    losses = torch.stack(probe.losses).float().cpu().numpy()
    require(bool(np.isfinite(losses).all()), f"msa/seqsim losses {losses}")
    epochs = text_epochs(probe, backbones=("sequence", "msa"))
    require([e["epoch"] for e in epochs] == [0, 1], f"epochs {epochs}")
    n_val = MSA_EVAL_ITEMS // 8 + SEQSIM_EVAL_ITEMS // 16
    total = dict(none)
    for e in epochs:
        enc, val_enc = e["encodes"], e["val_encodes"]
        want = {**none, "flash_mha_fwd": N_LAYERS * enc["sequence"],
                "tied_row_attention": MSA_LAYERS * enc["msa"]}
        want_val = {**none, "flash_mha_fwd": N_LAYERS * val_enc["sequence"],
                    "tied_row_attention": MSA_LAYERS * val_enc["msa"]}
        require(e["launches"] == want and e["val_launches"] == want_val,
                f"msa/seqsim epoch {e['epoch']} launches {e['launches']} / "
                f"{e['val_launches']}, want {want} / {want_val}")
        if e["epoch"] == 0:
            # every batch misses: the hub on both sides of a seqsim batch
            n_msa = e["by_modality"]["msa"]["steps"]
            n_sim = e["by_modality"]["seqsim"]["steps"]
            require(enc == {"sequence": n_msa + 2 * n_sim, "msa": n_msa}
                    and val_enc["msa"] == MSA_EVAL_ITEMS // 8
                    and val_enc["sequence"] == n_val + SEQSIM_EVAL_ITEMS // 16,
                    f"msa/seqsim epoch 1 forwards {enc} / {val_enc}")
        else:
            require(e["launches"] == e["val_launches"] == none
                    and e["cache_hit_rate"] == e["val_cache_hit_rate"] == 1.0,
                    f"msa/seqsim epoch 2: launches {e['launches']} / "
                    f"{e['val_launches']}, hit rates {e['cache_hit_rate']} / "
                    f"{e['val_cache_hit_rate']}")
        for k in none:
            total[k] += e["launches"][k] + e["val_launches"][k]
    require(launches["msa_seqsim"] == total, f"msa/seqsim launches "
            f"{launches['msa_seqsim']}, want {total}")
    cache = trainer._feature_cache
    keys = {ns: sum(k.startswith(ns) for k in cache._store)
            for ns in (b"msa|", b"sequence|")}
    out = {"items": {"msa": counts, "seqsim": SEQSIM_ITEMS},
           "fit_s": fit_s, "steps": module.step,
           "epochs": [{k: v for k, v in e.items()
                       if k not in ("launches", "val_launches")}
                      for e in epochs],
           "launches_per_epoch": [e["launches"] for e in epochs],
           "cache_host_bytes": cache.host_bytes(),
           "cache_entries": {k.decode(): v for k, v in keys.items()},
           "val_loss": metrics["val/loss"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches["msa_seqsim"]}
    for e in epochs:
        print(f"  msa/seqsim epoch {e['epoch']}: {e['batches']} steps, "
              f"{e['pairs_per_s']:.1f} pairs/s (" + ", ".join(
                  f"{m}: {d['steps']} steps, {d['pairs_per_s']:.1f} pairs/s"
                  for m, d in e["by_modality"].items())
              + f"); median batch {e['median_batch_ms']:.1f} ms (loader "
              f"{e['median_split_ms']['loader']:.1f}, lookup "
              f"{e['median_split_ms']['lookup']:.1f}, step "
              f"{e['median_split_ms']['step']:.1f}); hit rate "
              f"{e['cache_hit_rate']:.3f} / val {e['val_cache_hit_rate']:.3f}; "
              f"backbone forwards {e['encodes']} / val {e['val_encodes']}; "
              f"validation {e['val_s']:.2f} s; launches {e['launches']}",
              flush=True)
    print(f"  msa/seqsim: fit {fit_s:.2f} s, {module.step} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, val/loss "
          f"{out['val_loss']:.4f}; cache {out['cache_entries']} entries, "
          f"{out['cache_host_bytes'] / 2**20:.1f} MiB on the host (an MSA's "
          f"key is its [50, 1024] token block); peak {out['peak_gib']:.2f} "
          f"GiB; {smi}", flush=True)
    del module, hub, tower, trainer
    torch.cuda.empty_cache()
    return out


class MemoryStructs(StructDataset):
    """The package's StructDataset with its structures in memory (the
    card's host has no h5py): ids from the split's CSV, as the package
    reads them, (full sequence, graph sequence, atom names, residue ids,
    xyz) from `records`."""

    def __init__(self, records: dict, **kwargs):
        super().__init__(**kwargs)
        self.records = records

    def read_structure(self, seq_id: str):
        return self.records.get(seq_id)


def graph_records(root: str, rng, counts: dict, pocket_residues: int,
                  median: float = 290.0, longest: int = 1022) -> dict:
    """{"struct_graph": records, "pocket": records} for `counts` ids a
    split: a chain of log-normal length (clipped to [30, longest]) and a
    pocket cut-out of its first `pocket_residues` residues, each written
    as PDB text and parsed by structure_io; `{split}_seqstruc.csv` and
    `{split}_pocket.csv` list the ids."""
    out = {"struct_graph": {}, "pocket": {}}
    pdb_dir = os.path.join(root, "pdb")
    os.makedirs(pdb_dir, exist_ok=True)
    for split, n in counts.items():
        ids = [f"{split}_{i:05d}" for i in range(n)]
        lens = np.clip(rng.lognormal(np.log(median), 0.65, n), 30, longest)
        for sid, n_res in zip(ids, lens.astype(int)):
            seq = "".join(rng.choice(list(AAS), n_res))
            for kind, part in (("struct_graph", seq),
                               ("pocket", seq[:pocket_residues])):
                path = os.path.join(pdb_dir, f"{sid}_{kind}.pdb")
                with open(path, "w") as f:
                    f.write(synthetic.backbone_pdb(part, rng))
                out[kind][sid] = (seq, *parse_chain(path))
        for kind in ("seqstruc", "pocket"):
            with open(os.path.join(root, f"{split}_{kind}.csv"), "w") as f:
                f.write("".join(f"{sid},0\n" for sid in ids))
    return out


# the shipped default configs/train.yaml (data: oneprot = pocket, seqsim,
# struct_graph, text; model: oneprot = the 650M hub, ProNet struct_graph and
# pocket, BiomedBERT-base text), only the paths, the accelerator, the epochs
# and the data module's alias overridden
DEFAULT_CLI = ("trainer=gpu", "trainer.max_epochs=2", "extras.print_config=false")
DEFAULT_ITEMS, DEFAULT_EVAL_ITEMS, DEFAULT_SEED = 64, 32, 23
POCKET_RESIDUES = 100  # pockets_100_residues.h5


def default_cli_phase(smi: str, launches: dict, hub_dir: str) -> dict:
    """configs/train.yaml as shipped through `cli.train.main`: 2 epochs and
    the test split on synthetic pairs (struct_graph, pocket and the text
    tower's sequences from memory; text, seqsim files on disk). Gated: no
    plain version, 33 #1 a hub forward and 12 a BERT forward and nothing
    else, finite losses and metrics. Fills launches["default_cli"]. Then,
    on its run dir (nothing trains twice), `eval_phase` and
    `collect_phase` (with the hub checkpoint at `hub_dir`)."""
    none = {name: 0 for name in LAUNCHERS}
    rng = np.random.RandomState(DEFAULT_SEED)
    counts = {"train": DEFAULT_ITEMS, "val": DEFAULT_EVAL_ITEMS,
              "test": DEFAULT_EVAL_ITEMS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_default_cli_") as root:
        t = time.time()
        records = graph_records(root, rng, counts, POCKET_RESIDUES)
        text = {}
        for split, n in counts.items():
            ids = [f"{split}_{i:05d}" for i in range(n)]
            texts = sample_texts(n, rng)
            for sid in ids:
                text[sid] = records["struct_graph"][sid][0]
            with open(os.path.join(root, f"{split}_text.csv"), "w") as f:
                f.write("".join(f"{sid},{x}\n" for sid, x in zip(ids, texts)))
        seqsim_files(root, rng, counts)
        data_s = time.time() - t
        CliDataModule.RECORDS = {**records, "text": text}
        register_target_alias(CLI_DATA_TARGET, f"{__name__}.CliDataModule")
        probe = CliProbe()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            metrics = probe.main(list(DEFAULT_CLI) + [
                f"paths.data_dir={root}", f"hydra.run.dir={root}/run"])
            launches["default_cli"] = read_launches()
            plain = dict(PLAIN_CALLS)
        finally:
            probe.close()
            TARGET_ALIASES.pop(CLI_DATA_TARGET, None)
            CliDataModule.RECORDS = {}
        torch.cuda.empty_cache()
        phase("eval: cli.eval.main on the train.yaml run, 128 rows x 4 "
              "modalities, then from a reference Lightning .ckpt")
        evaluation = eval_phase(root, records, os.path.join(root, "run"),
                                launches, smi)
        phase("collect_embeddings: cli.collect_embeddings.main, the hub "
              "checkpoint as esm2 and the train.yaml run as oneprot")
        collect = collect_phase(root, hub_dir, os.path.join(root, "run"),
                                launches, smi)
        phase("downstream probes: cli.saprot_fit_mlp on the collected "
              "embeddings, then the MLP probe at SaProt's widths (1280 in, "
              "EC, GO-BP, DeepLoc10, ThermoStability; 16384 / 2048 / 2048 "
              "rows), card vs CPU")
        probes = probe_phase(root, os.path.join(root, "embeddings"),
                             launches, smi)
    require(not any(plain.values()), f"default cli: plain versions ran on the "
            f"card: {plain}")
    run = probe.runs[0]
    module = run["module"]
    require(set(module.encoders) == {"sequence", "struct_graph", "pocket",
                                     "text"}, f"encoders {set(module.encoders)}")
    epochs = text_epochs(run["probe"], backbones=("sequence", "text"))
    require([e["epoch"] for e in epochs] == [0, 1], f"epochs {epochs}")
    total = dict(none)
    for e in epochs:
        for got, enc in ((e["launches"], e["encodes"]),
                         (e["val_launches"], e["val_encodes"])):
            want = {**none, "flash_mha_fwd": N_LAYERS * enc["sequence"]
                    + TEXT_LAYERS * enc["text"]}
            require(got == want, f"default cli epoch {e['epoch']} launches "
                    f"{got}, want {want}")
            for k in none:
                total[k] += got[k]
    # seqsim is not trained (model/oneprot.yaml: use_seqsim false)
    require(sorted(set(run["probe"].step_modalities))
            == ["pocket", "struct_graph", "text"],
            f"trained {set(run['probe'].step_modalities)}")
    test_enc = run["test_launches"]["flash_mha_fwd"]
    require(run["test_launches"] == {**none, "flash_mha_fwd": test_enc},
            f"default cli test launches {run['test_launches']}")
    for k in none:
        total[k] += run["test_launches"][k]
    require(launches["default_cli"] == total, f"default cli launches "
            f"{launches['default_cli']}, want {total}")
    losses = torch.stack(run["probe"].losses).float().cpu().numpy()
    finite = [v for k, v in metrics.items() if k.startswith(("val/", "test/"))]
    require(bool(np.isfinite(losses).all()) and len(finite) > 20
            and bool(np.isfinite(finite).all()), f"default cli metrics {metrics}")
    out = {"items": counts, "data_s": data_s, "model_build_s": run["build_s"],
           "fit_s": run["fit_s"], "test_s": run["test_s"],
           "main_s": run["main_s"], "steps": module.step,
           "epochs": [{k: v for k, v in e.items()
                       if k not in ("launches", "val_launches")}
                      for e in epochs],
           "checkpoint_saves": run["probe"].saves,
           "val_loss": metrics["val/loss"], "test_loss": metrics["test/loss"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches["default_cli"], "eval": evaluation,
           "collect": collect, "probes": probes}
    for e in epochs:
        print(f"  train.yaml epoch {e['epoch']}: {e['batches']} steps, "
              f"{e['pairs_per_s']:.1f} pairs/s (" + ", ".join(
                  f"{m}: {d['steps']} steps, {d['pairs_per_s']:.1f} pairs/s"
                  for m, d in e["by_modality"].items())
              + f"); median batch {e['median_batch_ms']:.1f} ms (loader "
              f"{e['median_split_ms']['loader']:.1f}, lookup "
              f"{e['median_split_ms']['lookup']:.1f}, step "
              f"{e['median_split_ms']['step']:.1f}); hit rate "
              f"{e['cache_hit_rate']:.3f} / val {e['val_cache_hit_rate']:.3f}; "
              f"backbone forwards {e['encodes']} / val {e['val_encodes']}; "
              f"validation {e['val_s']:.2f} s; launches {e['launches']}",
              flush=True)
    print(f"  train.yaml: data {data_s:.2f} s, build {run['build_s']:.2f} s, "
          f"fit {run['fit_s']:.2f} s, test {run['test_s']:.2f} s, "
          f"{module.step} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"val/loss {out['val_loss']:.4f}, test/loss {out['test_loss']:.4f}; "
          "checkpoints " + ", ".join(f"{s['name']} {s['s']:.2f} s"
                                     for s in run["probe"].saves)
          + f"; peak {out['peak_gib']:.2f} GiB; launches "
          f"{launches['default_cli']}; {smi}", flush=True)
    return out


# ---------------------------------------------------------------------------
# checkpoint interop and the eval entry points: a local HF checkpoint of the
# 650M hub (int8, with the canary), cli.eval on the default train.yaml run
# (also from a reference Lightning .ckpt), cli.collect_embeddings

HUB_CONFIG = {"architectures": ["EsmForMaskedLM"], "model_type": "esm",
              "vocab_size": 33, "hidden_size": 1280, "num_hidden_layers": 33,
              "num_attention_heads": 20, "intermediate_size": 5120,
              "pad_token_id": 1, "mask_token_id": 32, "token_dropout": True,
              "layer_norm_eps": 1e-5, "position_embedding_type": "rotary",
              "emb_layer_norm_before": False, "max_position_embeddings": 1026}
HUB_SEED = 31
EVAL_ROWS, EVAL_BATCH, EVAL_SEED = 128, 16, 37
COLLECT_ROWS, COLLECT_BATCH, COLLECT_SEED = 64, 32, 41
# a port transformer key's HF name, by layer part (ESM2; BERT where it
# differs), and the reference head's Sequential indices
HF_LAYER = {"attn_ln": "attention.LayerNorm", "attn.q": "attention.self.query",
            "attn.k": "attention.self.key", "attn.v": "attention.self.value",
            "attn.o": "attention.output.dense", "ffn_ln": "LayerNorm",
            "fc1": "intermediate.dense", "fc2": "output.dense"}
HF_BERT_LAYER = {**HF_LAYER, "attn_ln": "attention.output.LayerNorm",
                 "ffn_ln": "output.LayerNorm"}
HF_TOP = {"embed_tokens.weight": "embeddings.word_embeddings.weight",
          "final_ln.weight": "encoder.emb_layer_norm_after.weight",
          "final_ln.bias": "encoder.emb_layer_norm_after.bias",
          "word_embeddings": "embeddings.word_embeddings.weight",
          "position_embeddings": "embeddings.position_embeddings.weight",
          "token_type_embeddings": "embeddings.token_type_embeddings.weight",
          "emb_ln.weight": "embeddings.LayerNorm.weight",
          "emb_ln.bias": "embeddings.LayerNorm.bias"}
REF_HEAD = {"proj.ln.": "proj.0.", "proj.dense.": "proj.1.",
            "proj.ln1.": "proj.0.", "proj.dense1.": "proj.1.",
            "proj.ln2.": "proj.3.", "proj.dense2.": "proj.4."}
SAFETENSORS_DTYPE = {torch.float32: "F32", torch.bfloat16: "BF16",
                     torch.int64: "I64"}


def hf_name(key: str, bert_names: bool = False) -> str:
    """A port ESM2 / BERT state-dict key -> the HF EsmModel / BertModel
    name (test-side: the writer's map, not a port feature)."""
    if key in HF_TOP:
        return HF_TOP[key]
    _, i, rest = key.split(".", 2)
    part, _, leaf = rest.rpartition(".")
    return (f"encoder.layer.{i}."
            f"{(HF_BERT_LAYER if bert_names else HF_LAYER)[part]}.{leaf}")


def reference_name(modality: str, key: str) -> str:
    """A port encoder's key (`transformer.…`, `head.…`) -> the reference
    OneProt Lightning module's state-dict name."""
    part, _, rest = key.partition(".")
    if part == "head":
        for port_name, ref in REF_HEAD.items():
            if rest.startswith(port_name):
                return (f"model.network.{modality}.{ref}"
                        f"{rest[len(port_name):]}")
        raise KeyError(key)
    return (f"model.network.{modality}.transformer."
            f"{hf_name(rest, modality == 'text')}")


def write_safetensors(path: str, tensors: dict) -> int:
    """A `.safetensors` file of CPU tensors (8-byte header length, JSON
    header, raw bytes, 8-byte aligned header); returns its size."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPE[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().reshape(-1).view(torch.uint8)
                               .numpy()))
    return os.path.getsize(path)


def write_hub_checkpoint(hub_dir: str) -> tuple:
    """The ESM2-650M hub as a local HF directory: config.json and an f32
    model.safetensors of seeded weights (HF names, plus the keys the
    converter ignores: position_ids, contact_head). Returns (seconds,
    bytes)."""
    t = time.time()
    os.makedirs(hub_dir, exist_ok=True)
    with open(os.path.join(hub_dir, "config.json"), "w") as f:
        json.dump(HUB_CONFIG, f)
    shapes = esm2.Esm2(esm2.resolve_esm2_config(hub_dir), device="meta",
                       dtype=torch.bfloat16).state_dict()
    gen = torch.Generator(device="cuda").manual_seed(HUB_SEED)
    tensors = {}
    for key, t_meta in shapes.items():
        x = torch.randn(t_meta.shape, generator=gen, device="cuda") * 0.02
        if key.endswith("ln.weight"):
            x = x + 1.0
        tensors[hf_name(key)] = x.cpu()
    tensors["embeddings.position_ids"] = torch.arange(1026)[None]
    tensors["contact_head.regression.weight"] = torch.zeros(1, 660)
    nbytes = write_safetensors(os.path.join(hub_dir, "model.safetensors"),
                               tensors)
    return time.time() - t, nbytes


def pretrained_hub_phase(hub_dir: str, smi: str, launches: dict) -> dict:
    """(a): write the 650M hub as a local HF checkpoint (f32 safetensors),
    read it back through the port's reader (timed), then compose
    `experiment=train_packed data=struct_token_only` with the hub's
    `model_name_or_path` set to the directory and `quantize=int8` and call
    `cli.train.build_model`: the weights are loaded (float leaves equal the
    file's after the bf16 cast, the int8 codes and scales equal the
    file's quantized), the int8 canary runs (#1 33 x 2, #4 33, nothing
    else) and returns finite numbers; then one embed_sequences request.
    Fills launches["pretrained hub"] and launches["pretrained hub request"]."""
    from oneprot_tpu_torch.models import hf_convert

    none = {name: 0 for name in LAUNCHERS}
    write_s, nbytes = write_hub_checkpoint(hub_dir)
    t = time.time()
    file_state = hf_convert.load_torch_state_dict(hub_dir)
    read_s = time.time() - t
    argv = list(CLI_BASE) + list(CLI_MODEL) + [
        f"model.components.sequence.model_name_or_path={hub_dir}",
        "model.components.sequence.quantize=int8"]
    cfg = load_config(default_config_dir(), "train", argv)
    cfg = prepare_run_dir(cfg, output_dir=os.path.join(hub_dir, "run"))
    torch.cuda.synchronize()
    reset_launches()
    t = time.time()
    module = cli_train.build_model(cfg["model"], torch.device("cuda"), 0)
    torch.cuda.synchronize()
    build_s = time.time() - t
    launches["pretrained hub"] = read_launches()
    require(not any(PLAIN_CALLS.values()),
            f"pretrained hub: plain versions ran on the card: {PLAIN_CALLS}")
    want = {**none, "flash_mha_fwd": 2 * N_LAYERS, "gelu_quant": N_LAYERS}
    require(launches["pretrained hub"] == want, f"pretrained hub launches "
            f"{launches['pretrained hub']}, want {want}")
    canary = module.int8_canaries.get("sequence")
    require(canary is not None and canary["rows"] == 16 and all(
        np.isfinite(canary[k]) for k in ("cos_min", "cos_mean", "r1")),
        f"int8 canary {canary}")
    enc = module.encoders["sequence"]
    require(enc.pretrained_dir == hub_dir and enc.quant_int8, "hub encoder")
    converted = hf_convert.convert_esm2_state_dict(file_state, N_LAYERS)
    loaded = enc.transformer.state_dict()
    for key, want_t in converted.items():
        if key.endswith(".weight") and key.split(".")[-2] in esm2.INT8_LAYERS:
            # quantized on the host, as load_pretrained quantizes
            q, s = esm2.quantize_int8_kernel(want_t)
            ok = (torch.equal(loaded[key[:-6] + "weight_q"].cpu(), q)
                  and torch.equal(loaded[key[:-6] + "weight_scale"].cpu(), s))
        else:
            ok = torch.equal(loaded[key].cpu(), want_t.to(loaded[key].dtype))
        require(ok, f"pretrained hub: {key} differs from the file")
    seqs = sample_seqs(32, np.random.RandomState(HUB_SEED))
    reset_launches()
    t = time.time()
    feats = OneProtEmbedder(module.model, buckets=BUCKETS).embed_sequences(seqs)
    request_s = time.time() - t
    launches["pretrained hub request"] = read_launches()
    check_embeddings(feats, 32, "pretrained int8 hub")
    require(launches["pretrained hub request"] == {
        **none, "flash_mha_fwd": N_LAYERS, "gelu_quant": N_LAYERS},
        f"pretrained hub request launches {launches['pretrained hub request']}")
    out = {"file_bytes": nbytes, "write_s": write_s, "read_s": read_s,
           "read_gb_per_s": nbytes / read_s / 1e9, "build_s": build_s,
           "canary": canary, "canary_launches": launches["pretrained hub"],
           "request_ms": request_s * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"  pretrained hub: wrote {nbytes / 1e9:.3f} GB in {write_s:.2f} s; "
          f"read back by the port's safetensors reader in {read_s:.3f} s = "
          f"{out['read_gb_per_s']:.2f} GB/s (page cache warm); build_model "
          f"{build_s:.2f} s (read, convert, int8 quantize, canary); canary "
          f"centred cosine min {canary['cos_min']:.4f} mean "
          f"{canary['cos_mean']:.4f}, R@1 {canary['r1']:.4f} over "
          f"{canary['rows']} rows (random weights: reported, not gated); "
          f"launches {launches['pretrained hub']}; one request of 32 "
          f"{request_s * 1e3:.1f} ms; {smi}", flush=True)
    del module, enc, loaded, file_state, converted
    torch.cuda.empty_cache()
    return out


def eval_csv(root: str, records: dict, rng) -> tuple:
    """A combined eval CSV of EVAL_ROWS rows (header first) over the ids of
    `records`: 3Di strings as long as each sequence (so both share the
    sequence's bucket), texts from sample_texts, and every EVAL_BATCH-th
    text longer than 512 tokens, so that every batch pads its texts to 512
    as embed_texts does. Returns (path, sequences, texts)."""
    ids = list(records["struct_graph"])[:EVAL_ROWS]
    long_text = " ".join(rng.choice(TEXT_WORDS, TEXT_MAX_TOKENS + 88))
    seqs, texts = [], []
    path = os.path.join(root, "test_all_modalities.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(retrieval_eval.COLUMN_NAMES)
        for i, sid in enumerate(ids):
            seq = records["struct_graph"][sid][1]  # as read_structure gives it
            text = long_text if i % EVAL_BATCH == 0 else sample_texts(1, rng)[0]
            tdi = "".join(rng.choice(list(FOLDSEEK), len(seq)))
            writer.writerow([sid, f"{sid}.a3m", text, tdi, sid, sid, sid])
            seqs.append(seq)
            texts.append(text)
    return path, seqs, texts


def eval_phase(root: str, records: dict, run_dir: str, launches: dict,
               smi: str) -> dict:
    """(b): `cli.eval.main` on the default train.yaml run (4 modalities,
    structures from memory), then again from a reference Lightning `.ckpt`
    of its sequence and text towers. Gated: 6 pairs x 2 directions, all
    finite, the CSV layout, #1 exactly (33 + 12) x batches and nothing
    else, no plain version, the sequence and text embeddings equal
    `from_run_dir`'s and the Lightning run's. Fills launches["eval"] and
    launches["eval lightning"]."""
    none = {name: 0 for name in LAUNCHERS}
    csv_path, seqs, texts = eval_csv(root, records, np.random.RandomState(
        EVAL_SEED))
    batches = -(-len(seqs) // EVAL_BATCH)
    argv = [f"run_dir={run_dir}", f"csv_file={csv_path}",
            f"paths.data_dir={root}", f"paths.log_dir={root}/eval_logs",
            f"batch_size={EVAL_BATCH}"]

    def from_memory(self, h5_path, pid):
        kind = ("pocket" if h5_path.endswith("pockets_100_residues.h5")
                else "struct_graph")
        if pid not in records[kind]:
            raise KeyError(pid)
        return records[kind][pid][1:]

    captured, runs = {}, {}
    # seconds in each tower's forwards (to a synchronize) and in the host's
    # batch build (tokenizing, the graphs), first eval run only
    split = {"host batches": 0.0}
    saved = (retrieval_eval.CombinedDataset.read_structure,
             retrieval_eval.CombinedDataset.batches,
             retrieval_eval.embed_all, OneProtModel.forward)

    def capture(*a, **k):
        captured[len(captured)] = saved[2](*a, **k)
        return captured[len(captured) - 1]

    def timed_batches(self, batch_size):
        it = saved[1](self, batch_size)
        while True:
            t = time.time()
            batch = next(it, None)
            if not captured:
                split["host batches"] += time.time() - t
            if batch is None:
                return
            yield batch

    def timed_forward(self, inputs, modality="sequence"):
        t = time.time()
        out = saved[3](self, inputs, modality)
        if not captured:
            torch.cuda.synchronize()
            split[modality] = split.get(modality, 0.0) + time.time() - t
        return out

    try:
        retrieval_eval.CombinedDataset.read_structure = from_memory
        retrieval_eval.CombinedDataset.batches = timed_batches
        retrieval_eval.embed_all = capture
        OneProtModel.forward = timed_forward
        for name, extra in (("eval", []), ("eval lightning", None)):
            if extra is None:
                state = torch.load(os.path.join(
                    run_dir, "checkpoints", "best", checkpoint_lib.STATE_FILE),
                    map_location="cpu", weights_only=True)["model"]
                ckpt = os.path.join(root, "reference.ckpt")
                t = time.time()
                torch.save({"state_dict": {
                    reference_name(mod, k[len(f"encoders.{mod}."):]): v
                    for mod in ("sequence", "text") for k, v in state.items()
                    if k.startswith(f"encoders.{mod}.")}}, ckpt)
                runs["lightning_write_s"] = time.time() - t
                del state
                extra = [f"ckpt_path={ckpt}",
                         "output_csv=retrieval_results_lightning.csv"]
            torch.cuda.synchronize()
            reset_launches()
            t = time.time()
            results = cli_eval.main(argv + extra)
            torch.cuda.synchronize()
            runs[name] = {"s": time.time() - t, "results": results}
            launches[name] = read_launches()
            require(not any(PLAIN_CALLS.values()), f"{name}: plain versions "
                    f"ran on the card: {PLAIN_CALLS}")
            want = {**none, "flash_mha_fwd": (N_LAYERS + TEXT_LAYERS) * batches}
            require(launches[name] == want, f"{name} launches "
                    f"{launches[name]}, want {want}")
        embedder = OneProtEmbedder.from_run_dir(run_dir)
        direct = {"sequence": embedder.embed_sequences(seqs,
                                                        batch_size=EVAL_BATCH),
                  "text": embedder.embed_texts(texts, batch_size=EVAL_BATCH)}
        del embedder
    finally:
        (retrieval_eval.CombinedDataset.read_structure,
         retrieval_eval.CombinedDataset.batches, retrieval_eval.embed_all,
         OneProtModel.forward) = saved
    results = runs["eval"]["results"]
    emb, emb_ckpt = captured[0], captured[1]
    require(sorted(emb) == ["pocket", "sequence", "struct_graph", "text"]
            and all(e.shape == (EVAL_ROWS, 1024) and np.isfinite(e).all()
                    for e in emb.values()), "eval embeddings")
    require(len(results) == 6 and all(
        np.isfinite(v) for m in results.values() for v in m.values()),
        f"eval results {results}")
    with open(os.path.join(run_dir, "retrieval_results.csv")) as f:
        lines = f.read().splitlines()
    row = re.compile(r"^[a-z_]+-[a-z_]+ *,(?:[01]\.\d{3} {6},){4}\d+ *$")
    require(len(lines) == 13 and lines[0] == "Modality Pair           ,R@1"
            "        ,R@10       ,R@100      ,R@500      ,MR         "
            and all(row.match(x) and len(x.split(",")[0]) == 25
                    for x in lines[1:]), f"results csv {lines}")
    for m in ("sequence", "text"):
        require(np.array_equal(emb[m], direct[m]), f"eval {m} embeddings "
                "differ from from_run_dir's")
        require(np.array_equal(emb[m], emb_ckpt[m]), f"eval {m} embeddings "
                "from the Lightning .ckpt differ from the port checkpoint's")
    out = {"rows": EVAL_ROWS, "batches": batches, "eval_s": runs["eval"]["s"],
           "lightning_eval_s": runs["eval lightning"]["s"],
           "lightning_write_s": runs["lightning_write_s"],
           "rows_per_s": EVAL_ROWS / runs["eval"]["s"],
           "split_s": split,
           "rows_per_s_by_modality": {m: EVAL_ROWS / v for m, v in split.items()
                                      if m != "host batches"},
           "R@1": {p: m["seq_to_mod_R@1"] for p, m in results.items()},
           "launches": launches["eval"]}
    print(f"  eval: {EVAL_ROWS} rows x 4 modalities in {out['eval_s']:.2f} s "
          f"({out['rows_per_s']:.1f} rows/s, model build and restore "
          f"included; forwards " + ", ".join(
              f"{m} {v:.3f} s" for m, v in split.items()
              if m != "host batches")
          + f", host batches {split['host batches']:.3f} s); from a "
          f"Lightning .ckpt (written in "
          f"{out['lightning_write_s']:.2f} s) {out['lightning_eval_s']:.2f} s; "
          f"sequence and text embeddings equal from_run_dir's and the "
          f"Lightning run's; R@1 (random weights) {out['R@1']}; launches "
          f"{launches['eval']}; {smi}", flush=True)
    return out


def collect_phase(root: str, hub_dir: str, run_dir: str, launches: dict,
                  smi: str) -> dict:
    """(c): `cli.collect_embeddings.main` with the hub of (a) as `esm2`
    (`checkpoint_dir`) and the default run as `oneprot`, on ToyCls
    train/valid/test CSVs of COLLECT_ROWS rows. Gated: each combined file's
    rows and labels, #1 exactly 33 a batch of either model, and the `esm2`
    embeddings equal to the hub's masked mean computed here. Fills
    launches["collect"]."""
    from oneprot_tpu_torch.models import hf_convert

    none = {name: 0 for name in LAUNCHERS}
    rng = np.random.RandomState(COLLECT_SEED)
    down = os.path.join(root, "downstream")
    os.makedirs(down, exist_ok=True)
    splits = {}
    for split in ("train", "valid", "test"):
        seqs = sample_seqs(COLLECT_ROWS, rng)
        labels = rng.randint(0, 3, COLLECT_ROWS)
        splits[split] = (seqs, labels)
        with open(os.path.join(down, f"ToyCls_{split}.csv"), "w") as f:
            f.write("sequence,label\n" + "".join(
                f"{s},{y}\n" for s, y in zip(seqs, labels)))
    out_dir = os.path.join(root, "embeddings")
    torch.cuda.synchronize()
    reset_launches()
    t = time.time()
    outputs = cli_collect.main([
        "tasks=[ToyCls]", f"downstream_dir={down}", f"output_dir={out_dir}",
        f"batch_size={COLLECT_BATCH}", f"+models.esm2.checkpoint_dir={hub_dir}",
        "+models.oneprot.type=oneprot", f"+models.oneprot.run_dir={run_dir}",
        f"paths.log_dir={root}/collect_logs"])
    torch.cuda.synchronize()
    collect_s = time.time() - t
    launches["collect"] = read_launches()
    require(not any(PLAIN_CALLS.values()),
            f"collect: plain versions ran on the card: {PLAIN_CALLS}")
    batches = 3 * -(-COLLECT_ROWS // COLLECT_BATCH)
    want = {**none, "flash_mha_fwd": 2 * N_LAYERS * batches}
    require(launches["collect"] == want,
            f"collect launches {launches['collect']}, want {want}")
    require(len(outputs) == 6, f"collect outputs {outputs}")
    hub = esm2.Esm2(esm2.resolve_esm2_config(hub_dir), device="cuda",
                    dtype=torch.bfloat16).eval()
    hub.load_state_dict(hf_convert.convert_esm2_state_dict(
        hf_convert.load_torch_state_dict(hub_dir), N_LAYERS))
    tok = esm2_tokenizer()
    for split, (seqs, labels) in splits.items():
        for model, width in (("esm2", 1280), ("oneprot", 1024)):
            data = np.load(os.path.join(
                out_dir, model, f"ToyCls_{split}_embeddings_labels.npz"))
            require(data["embeddings"].shape == (COLLECT_ROWS, width)
                    and np.isfinite(data["embeddings"]).all()
                    and np.array_equal(data["labels_fitness"], labels),
                    f"collect {model} {split}")
        direct = []
        with torch.inference_mode():
            for start in range(0, COLLECT_ROWS, COLLECT_BATCH):
                chunk = seqs[start:start + COLLECT_BATCH]
                pad = pick_bucket(max(len(s) + 2 for s in chunk),
                                  list(DEFAULT_BUCKETS), 1024)
                ids = torch.from_numpy(tok(chunk, max_length=1024, padding=pad)
                                       ).to("cuda", torch.long)
                hidden = hub(ids)
                mask = (ids != 1).to(hidden.dtype)[..., None]
                direct.append(((hidden * mask).sum(1) / mask.sum(1)).float()
                              .cpu().numpy())
        got = np.load(os.path.join(
            out_dir, "esm2", f"ToyCls_{split}_embeddings_labels.npz"))
        require(np.array_equal(got["embeddings"], np.concatenate(direct)),
                f"collect esm2 {split}: not the hub's masked mean")
    del hub
    torch.cuda.empty_cache()
    n_seq = 2 * 3 * COLLECT_ROWS
    out = {"sequences": n_seq, "collect_s": collect_s,
           "seq_per_s": n_seq / collect_s, "launches": launches["collect"]}
    print(f"  collect_embeddings: 2 models x 3 splits x {COLLECT_ROWS} rows in "
          f"{collect_s:.2f} s ({out['seq_per_s']:.1f} seq/s, model builds "
          f"and the 2.6 GB checkpoint read included); esm2 embeddings equal "
          f"the hub's masked mean; launches {launches['collect']}; {smi}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# downstream probes: the collected ToyCls embeddings through the probe entry
# points, then the MLP probe at SaProt's widths on planted teachers

# SaProt's tasks of each family, their splits' order of size, the ESM2-650M
# hub's 1280-wide embeddings (saprot_mlp.yaml's probe defaults)
PROBE_TASKS = ("EC", "GO-BP", "DeepLoc10", "ThermoStability")
PROBE_ROWS = {"train": 16384, "valid": 2048, "test": 2048}
PROBE_DIM, PROBE_RANK, PROBE_NOISE, PROBE_SEED = 1280, 64, 0.5, 43
PROBE_LABEL_T = 2.5      # multi-label positives: z + noise > 2.5 (~1.3%)
PROBE_GAP_SHARE = 0.25   # the probe must close a quarter of the chance -> teacher gap
# card vs CPU: 3 epochs on the first 2048 train rows (16 steps an epoch)
PROBE_PARITY_EPOCHS, PROBE_PARITY_ROWS = 3, 2048
PROBE_VAL_REL, PROBE_LOGIT_COS, F1_MAX_REL = 1e-4, 0.99999, 1e-9
PROBE_MODULES = ("sklearn", "xgboost", "lmdb", "wandb")


def probe_teacher(rng, task: str, x: dict) -> dict:
    """{split: (labels, the teacher's noiseless scores)} of `task` for the
    embeddings `x[split]`: z = x A B, A [1280, 64] and B [64, out] drawn
    N(0, 1/fan-in) once for all splits (z about unit variance), the labels
    from z + N(0, 0.5^2): multi-label z + noise > 2.5 (about 1.3% of the
    labels positive), classification its argmax, regression column 0."""
    from oneprot_tpu_torch.downstream.mlp_probe import TASK_REGISTRY

    info = TASK_REGISTRY[task]
    a = rng.randn(PROBE_DIM, PROBE_RANK).astype(np.float32) / np.sqrt(PROBE_DIM)
    b = rng.randn(PROBE_RANK, info["output_dim"]).astype(np.float32) / np.sqrt(
        PROBE_RANK)
    out = {}
    for split, xs in x.items():
        z = (xs @ a) @ b
        noisy = z + PROBE_NOISE * rng.randn(*z.shape).astype(np.float32)
        if info["type"] == "multi-label":
            out[split] = (noisy > PROBE_LABEL_T).astype(np.int32), z
        elif info["type"] == "regression":
            out[split] = noisy[:, 0], z[:, :1]
        else:
            out[split] = noisy.argmax(1).astype(np.int64), z
    return out


def probe_chance_and_teacher(task_type: str, z: np.ndarray, y: np.ndarray,
                             rng) -> tuple:
    """The test metric that decides the gate (f1_max, accuracy, spearman),
    at chance (random scores; the majority class; 0) and for the teacher's
    noiseless scores."""
    from oneprot_tpu_torch.downstream import utils as probe_utils

    if task_type == "multi-label":
        return ("f1_max", probe_utils.count_f1_max(rng.rand(*y.shape), y),
                probe_utils.count_f1_max(z, y))
    if task_type == "regression":
        return "spearman", 0.0, probe_utils.spearman(z[:, 0], y)
    return ("accuracy", float(np.bincount(y).max() / len(y)),
            probe_utils.accuracy(y, z.argmax(1)))


def f1_max_float64(pred: torch.Tensor, target: torch.Tensor) -> float:
    """TorchDrug's f1_max, recomputed in float64 on the card (stable sorts,
    as the port's numpy version ranks ties)."""
    pred, target = pred.double(), target.double()
    b, n = pred.shape
    order = torch.sort(pred, dim=1, descending=True, stable=True).indices
    target_sorted = target.gather(1, order)
    cum = target_sorted.cumsum(1)
    precision = cum / torch.arange(1, n + 1, device=pred.device)
    recall = cum / (target.sum(1, keepdim=True) + 1e-10)
    is_start = torch.zeros_like(target_sorted, dtype=torch.bool)
    is_start[:, 0] = True
    is_start = torch.zeros_like(is_start).scatter(1, order, is_start)
    all_order = torch.sort(pred.flatten(), descending=True, stable=True).indices
    flat_order = (order + torch.arange(b, device=pred.device)[:, None] * n
                  ).flatten()
    inv = torch.empty_like(flat_order)
    inv[flat_order] = torch.arange(b * n, device=pred.device)
    is_start = is_start.flatten()[all_order]
    all_order = inv[all_order]
    precision, recall = precision.flatten(), recall.flatten()
    zero = torch.zeros((), dtype=torch.float64, device=pred.device)
    all_p = precision[all_order] - torch.where(is_start, zero,
                                               precision[all_order - 1])
    all_p = all_p.cumsum(0) / is_start.cumsum(0)
    all_r = recall[all_order] - torch.where(is_start, zero,
                                            recall[all_order - 1])
    all_r = all_r.cumsum(0) / b
    return float((2 * all_p * all_r / (all_p + all_r + 1e-10)).max())


def read_results(path: str) -> list:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = [h.strip() for h in rows[0]]
    return [dict(zip(header, (v.strip() for v in r))) for r in rows[1:]]


def probe_entry_points(root: str, emb_dir: str) -> dict:
    """`cli.saprot_fit_mlp.main` on the collected ToyCls files, config form
    on the `esm2` ones and flag form on the `oneprot` ones, on the card:
    the results CSVs' columns and finite values."""
    from oneprot_tpu_torch.cli import saprot_fit_mlp

    out = {}
    t = time.time()
    config_rows = saprot_fit_mlp.main([
        f"emb_dir={emb_dir}/esm2", "task_name=ToyCls", "model_type=esm2",
        f"results_dir={root}/probe_results"])
    flag_rows = saprot_fit_mlp.main([
        "--embeddings-dir", f"{emb_dir}/oneprot", "--task", "ToyCls",
        "--output-csv", f"{root}/probe_results/flags.csv"])
    out["mlp_s"] = time.time() - t
    config_csv = read_results(f"{root}/probe_results/ToyCls_mlp_results.csv")
    flag_csv = read_results(f"{root}/probe_results/flags.csv")
    keys = ["accuracy", "f1", "auc", "val_loss"]
    require([list(r) for r in config_csv] == [keys + ["task", "model_type"]]
            and [list(r) for r in flag_csv] == [keys + ["task"]]
            and config_csv[0]["model_type"] == "esm2"
            and all(r["task"] == "ToyCls" for r in config_csv + flag_csv)
            and np.isfinite([float(r[k]) for r in config_csv + flag_csv
                             for k in keys]).all(),
            f"probe CSVs {config_csv} {flag_csv}")
    out["config_form"], out["flag_form"] = config_rows[0], flag_rows[0]
    print(f"  saprot_fit_mlp on the collected ToyCls embeddings (64 rows a "
          f"split), config form (esm2, 1280 wide): {out['config_form']}; "
          f"flag form (oneprot, 1024 wide): {out['flag_form']}; both in "
          f"{out['mlp_s']:.2f} s", flush=True)
    return out


def probe_booster(root: str, emb_dir: str):
    """`cli.saprot_fit_cls.main` on the collected `esm2` ToyCls files: an
    ImportError naming xgboost and scikit-learn where neither is installed
    (the card's host), else the booster's metrics."""
    from oneprot_tpu_torch.cli import saprot_fit_cls

    try:
        out = saprot_fit_cls.main([
            f"emb_dir={emb_dir}/esm2", "task_name=ToyCls",
            f"results_dir={root}/probe_results"])
    except ImportError as e:
        require("xgboost" in str(e) and "scikit-learn" in str(e),
                f"saprot_fit_cls's ImportError: {e}")
        out = f"ImportError: {e}"
    print(f"  saprot_fit_cls on the collected ToyCls embeddings: {out}",
          flush=True)
    return out


def probe_phase(root: str, emb_dir: str, launches: dict, smi: str) -> dict:
    """The downstream probes. (a) `probe_entry_points` on the files of
    `collect_phase`. (b) `fit_mlp_probe` with saprot_mlp.yaml's defaults
    (hidden 512, dropout 0.2, lr 1e-3, batch 128, up to 50 epochs, patience
    5) on 1280-wide embeddings (the 650M hub's) drawn from PROBE_SEED,
    16384 / 2048 / 2048 rows, for EC (585, multi-label), GO-BP (1943,
    multi-label), DeepLoc10 (10 classes) and ThermoStability (regression),
    each with its planted teacher (`probe_teacher`). Gated: the probe's
    parameters and batches on the card; each task's test metric (f1_max,
    accuracy, spearman) at or above chance + PROBE_GAP_SHARE x (teacher -
    chance), the teacher's metric being that of its noiseless scores; card
    vs CPU from the same seeded weights at dropout 0 for
    PROBE_PARITY_EPOCHS epochs of the first PROBE_PARITY_ROWS train rows
    (the CPU half's cost): the best validation loss within rel 1e-4,
    the test logits' cosine >= 0.99999, the same epochs; the port's
    count_f1_max on the card's GO-BP test scores (compute_metrics', timed
    there) equal to `f1_max_float64` on the card (rel 1e-9); no kernel and
    no plain version launched; none of sklearn, xgboost, lmdb and wandb
    loaded. (c) `probe_booster`, last. Fills launches["probe"]."""
    from oneprot_tpu_torch.downstream import mlp_probe

    t0 = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = {"entry_points": probe_entry_points(root, emb_dir)}
    rng = np.random.RandomState(PROBE_SEED)
    t = time.time()
    x = {s: rng.randn(n, PROBE_DIM).astype(np.float32)
         for s, n in PROBE_ROWS.items()}
    out["data_s"] = time.time() - t
    cfg = mlp_probe.MLPProbeConfig()  # saprot_mlp.yaml's model defaults
    out["tasks"] = {}
    go_logits = go_labels = go_f1 = None
    for task in PROBE_TASKS:
        task_type = mlp_probe.TASK_REGISTRY[task]["type"]
        teacher = probe_teacher(np.random.RandomState(
            [PROBE_SEED, PROBE_TASKS.index(task)]), task, x)
        splits = {split: (x[split], teacher[split][0]) for split in x}
        z_test = teacher["test"][1]
        stats = {}
        metrics = mlp_probe.fit_mlp_probe(
            splits["train"], splits["valid"], splits["test"], task, cfg,
            stats=stats)
        name, chance, best = probe_chance_and_teacher(
            task_type, z_test, splits["test"][1], np.random.RandomState(0))
        need = chance + PROBE_GAP_SHARE * (best - chance)
        steps_s = stats["steps"] / stats["train_s"]
        row = {"metrics": metrics, "gate_metric": name, "chance": chance,
               "teacher": best, "need": need, "epochs": stats["epochs"],
               "best_epoch": stats["best_epoch"], "steps": stats["steps"],
               "steps_per_s": steps_s,
               "rows_per_s": stats["epochs"] * PROBE_ROWS["train"]
               / stats["train_s"],
               "epoch_ms": 1e3 * stats["train_s"] / stats["epochs"],
               "val_ms": 1e3 * stats["val_s"] / stats["epochs"],
               "test_ms": 1e3 * stats["test_s"],
               "metrics_ms": 1e3 * stats["metrics_s"],
               "positive_share": float(np.mean(splits["train"][1]))
               if task_type == "multi-label" else None}
        out["tasks"][task] = row
        print(f"  {task} ({task_type}, {mlp_probe.TASK_REGISTRY[task]['output_dim']}"
              f" outputs): {stats['epochs']} epochs (best {stats['best_epoch']}),"
              f" {stats['steps']} steps, {steps_s:.1f} steps/s, "
              f"{row['rows_per_s']:.0f} rows/s, {row['epoch_ms']:.1f} ms an "
              f"epoch, validation {row['val_ms']:.2f} ms, test "
              f"{row['test_ms']:.2f} ms; {name} {metrics[name]:.4f} (chance "
              f"{chance:.4f}, teacher {best:.4f}, gate >= {need:.4f}); "
              f"{metrics}; on {stats['params_device']} / "
              f"{stats['data_device']}", flush=True)
        require(stats["params_device"].startswith("cuda")
                and stats["data_device"].startswith("cuda"),
                f"{task}: the probe is not on the card: {stats}")
        require(metrics[name] >= need, f"{task}: {name} {metrics[name]} under "
                f"{need} (chance {chance}, teacher {best})")
        if task == "GO-BP":
            go_logits, go_labels = stats["test_logits"], splits["test"][1]
            go_f1 = metrics["f1_max"], 1e3 * stats["metrics_s"]
        # card vs CPU from the same seeded weights, dropout 0
        short = dataclasses.replace(cfg, dropout=0.0,
                                    max_epochs=PROBE_PARITY_EPOCHS)
        runs, head = {}, tuple(a[:PROBE_PARITY_ROWS] for a in splits["train"])
        for device in ("cuda", "cpu"):
            st = {}
            m = mlp_probe.fit_mlp_probe(head, splits["valid"], splits["test"],
                                        task, short, device=device, stats=st)
            runs[device] = (m, st)
        (mc, sc), (mh, sh) = runs["cuda"], runs["cpu"]
        val_rel = abs(mc["val_loss"] - mh["val_loss"]) / abs(mh["val_loss"])
        logit_cos = cosine(torch.from_numpy(sc["test_logits"]).flatten(),
                           torch.from_numpy(sh["test_logits"]).flatten())
        row["parity"] = {"val_loss_card": mc["val_loss"],
                         "val_loss_cpu": mh["val_loss"], "val_rel": val_rel,
                         "test_logit_cosine": logit_cos,
                         "epochs": [sc["epochs"], sh["epochs"]],
                         "cpu_epoch_ms": 1e3 * sh["train_s"] / sh["epochs"]}
        print(f"    card vs CPU, dropout 0, {PROBE_PARITY_EPOCHS} epochs of "
              f"{PROBE_PARITY_ROWS} rows: "
              f"val_loss {mc['val_loss']:.7f} / {mh['val_loss']:.7f} (rel "
              f"{val_rel:.2e}, gate <= {PROBE_VAL_REL}), test-logit cosine "
              f"{logit_cos:.8f} (gate >= {PROBE_LOGIT_COS}), epochs "
              f"{sc['epochs']} / {sh['epochs']}; CPU "
              f"{row['parity']['cpu_epoch_ms']:.0f} ms an epoch", flush=True)
        require(val_rel <= PROBE_VAL_REL and logit_cos >= PROBE_LOGIT_COS
                and sc["epochs"] == sh["epochs"] == PROBE_PARITY_EPOCHS,
                f"{task}: card vs CPU {row['parity']}")
    # compute_metrics' scores; its f1_max, timed in the fit, is the host's
    probs = 1.0 / (1.0 + np.exp(-go_logits))
    host, f1_ms = go_f1
    card = f1_max_float64(torch.from_numpy(probs).cuda(),
                          torch.from_numpy(go_labels).cuda())
    out["f1_max"] = {"host": host, "card_float64": card, "host_ms": f1_ms,
                     "shape": list(probs.shape)}
    launches["probe"] = read_launches()
    loaded = [m for m in PROBE_MODULES if m in sys.modules]
    out.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               plain=dict(PLAIN_CALLS), loaded=loaded, s=time.time() - t0)
    print(f"  f1_max at GO-BP's test size {list(probs.shape)}: host (numpy "
          f"float64) {host:.12f} in {f1_ms:.1f} ms, card float64 "
          f"{card:.12f}; peak {out['peak_gib']:.2f} GiB; launches "
          f"{launches['probe']}; loaded of {PROBE_MODULES}: {loaded}; phase "
          f"{out['s']:.1f} s; {smi}", flush=True)
    require(abs(host - card) <= F1_MAX_REL * abs(card),
            f"f1_max {host} against the float64 recomputation {card}")
    require(not any(launches["probe"].values())
            and not any(PLAIN_CALLS.values()),
            f"probe: launches {launches['probe']}, plain {PLAIN_CALLS}")
    require(not loaded, f"probe: {loaded} loaded")
    out["entry_points"]["booster"] = probe_booster(root, emb_dir)
    return out


# the f32 debug experiments as shipped (ESM2-8M towers, bert_tiny, ProNet
# 32 x 2, the 64-wide MSA tower with heads of 16), on the card
F32_EXPERIMENTS = (
    ("debug_struct_token", ("experiment=debug_struct_token", "trainer=gpu")),
    ("train_packed", ("experiment=train_packed", "trainer=gpu",
                      "data=struct_token_only", "trainer.max_epochs=1")),
    ("debug_all_modalities", ("experiment=debug_all_modalities",
                              "trainer=gpu")))
F32_ITEMS, F32_EVAL_ITEMS, F32_SEED = 64, 16, 29


def f32_experiments_phase(smi: str, launches: dict) -> dict:
    """experiment=debug_struct_token, train_packed (data=struct_token_only)
    and debug_all_modalities through `cli.train.main` as shipped, f32 on
    the card: each runs to its end (train and test) through the f32
    instances of #1-#3 and no bf16 flash-MHA launch; debug_all_modalities'
    MSA tower (heads of 16) through #8's zero-padded launch, 2 a forward.
    Fills launches["f32 <experiment>"]."""
    out = {}
    rng = np.random.RandomState(F32_SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f32_") as root:
        t = time.time()
        counts = {"train": F32_ITEMS, "val": F32_EVAL_ITEMS,
                  "test": F32_EVAL_ITEMS}
        tokens = struct_token_records(root, np.random.RandomState(TRAINER_SEED))
        records = graph_records(root, rng, counts, 16, median=60.0)
        text = {}
        for split, n in counts.items():
            ids = [f"{split}_{i:05d}" for i in range(n)]
            for sid in ids:
                text[sid] = records["struct_graph"][sid][0]
            with open(os.path.join(root, f"{split}_text.csv"), "w") as f:
                f.write("".join(f"{sid},{x}\n" for sid, x in zip(
                    ids, sample_texts(n, rng))))
        msa_files(root, rng, counts, homologs=8)
        seqsim_files(root, rng, counts)
        data_s = time.time() - t
        CliDataModule.RECORDS = {**records, "text": text,
                                 "struct_token": tokens}
        register_target_alias(CLI_DATA_TARGET, f"{__name__}.CliDataModule")
        probe = CliProbe()
        try:
            for name, argv in F32_EXPERIMENTS:
                torch.cuda.synchronize()
                reset_launches()
                t = time.time()
                metrics = probe.main(list(argv) + [
                    f"paths.data_dir={root}", f"hydra.run.dir={root}/{name}",
                    "extras.print_config=false"])
                wall = time.time() - t
                launches[f"f32 {name}"] = read_launches()
                run = probe.runs[-1]
                out[name] = {"main_s": wall, "steps": run["module"].step,
                             "val_loss": metrics.get("val/loss"),
                             "test_loss": metrics.get("test/loss"),
                             "plain": dict(PLAIN_CALLS),
                             "launches": launches[f"f32 {name}"],
                             "metrics_finite": bool(np.isfinite([
                                 v for k, v in metrics.items()
                                 if k.startswith(("val/", "test/"))]).all())}
        finally:
            probe.close()
            TARGET_ALIASES.pop(CLI_DATA_TARGET, None)
            CliDataModule.RECORDS = {}
    for (name, _), run in zip(F32_EXPERIMENTS, probe.runs):
        got = out[name]
        n = got["launches"]
        print(f"  {name} (f32): {got['steps']} steps, main {got['main_s']:.2f} "
              f"s, val/loss {got['val_loss']:.4f}, test/loss "
              f"{got['test_loss']:.4f}; f32 #1 {n['flash_mha_fwd_f32']}, #2 "
              f"{n['flash_mha_bwd_dq_f32']}, #3 {n['flash_mha_bwd_dkv_f32']}, "
              f"#8 at heads of 16 {n['tied_row_attention']}, bf16 #1 "
              f"{n['flash_mha_fwd']}; {smi}", flush=True)
        require(not any(got["plain"].values()),
                f"{name}: plain versions ran on the card: {got['plain']}")
        require(got["metrics_finite"] and got["test_loss"] is not None
                and got["steps"] > 0, f"{name}: did not run to its end {got}")
        require(min(n[k] for k in F32_NAMES) > 0 and n["flash_mha_fwd"] == 0
                and n["flash_mha_bwd_dq"] == n["flash_mha_bwd_dkv"] == 0,
                f"{name}: launches {n}")
        if name == "debug_all_modalities":
            msa_forwards = run["probe"].step_modalities.count("msa")
            require(n["tied_row_attention"] >= 2 * msa_forwards > 0,
                    f"{name}: #8 launches {n['tied_row_attention']} over "
                    f"{msa_forwards} MSA steps")
        else:
            require(n["tied_row_attention"] == 0, f"{name}: #8 launches")
    out["data_s"] = data_s
    return out


def exact_f32() -> None:
    """No TF32 in f32 products, in this process and in its children."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    exact_f32()

    phase("device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"  {kind}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, Python {sys.version.split()[0]}", flush=True)

    phase("build")
    t = time.time()
    _build.build_all()
    print(f"  built in {time.time() - t:.1f} s into {_build.BUILD_DIR}", flush=True)
    for name in _build.SIGNATURES:
        for instance, line in ptxas_report(_build.build_log(name)):
            print(f"  {name} {instance}: {line}", flush=True)

    phase("kernels against their plain versions")
    count_plain_calls()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_row = check_flash(gen)
    rows = [fwd_row, *check_flash_bwd(gen, fwd_row), check_gelu_quant(gen),
            check_tied_row(gen), check_flash_attention(gen),
            *check_flash_attention_bwd(gen)]
    check_flash_attention_segments(gen, rows)
    text_kernels = check_flash_text(gen, rows[:3])
    rows += check_flash_f32(gen)
    tied_row = next(r for r in rows if r["name"] == "tied_row_attention")
    tied_row["narrow_heads"] = check_tied_row_narrow(gen)

    phase("serving: ESM2-650M hub, bf16")
    rng = np.random.RandomState(0)
    requests = [sample_seqs(32, rng) for _ in range(3)]
    batches = len(requests)  # 32 sequences a request, batch_size 32
    # the entry point's defaults: ESM2-650M, 1024 wide, bf16, on the card
    enc = create_sequence_encoder(proj_type="mlp")
    esm2.init_esm2_weights_(enc, torch.Generator(device="cuda").manual_seed(0))
    embedder = OneProtEmbedder(OneProtModel({"sequence": enc}), buckets=BUCKETS)
    launches = {}  # path -> {kernel: launches in that path's run}
    reset_launches()
    feats_bf16, secs_bf16 = serve(embedder, requests, "bf16 hub")
    launches["bf16 hub"] = read_launches()
    none = {name: 0 for name in LAUNCHERS}
    require(launches["bf16 hub"] == {**none, "flash_mha_fwd": N_LAYERS * batches},
            f"bf16 hub launches: {launches['bf16 hub']}")
    check_retrieval(embedder, feats_bf16, rng, "bf16 hub")

    phase("serving: ESM2-650M hub, int8")
    enc8 = create_sequence_encoder(proj_type="mlp", quantize="int8")
    enc8.load_state_dict(esm2.quantize_esm2_int8_tree(enc.state_dict()))
    embedder8 = OneProtEmbedder(OneProtModel({"sequence": enc8}), buckets=BUCKETS)
    reset_launches()
    feats_int8, secs_int8 = serve(embedder8, requests, "int8 hub")
    launches["int8 hub"] = read_launches()
    require(launches["int8 hub"] == {**none, "flash_mha_fwd": N_LAYERS * batches,
                                     "gelu_quant": N_LAYERS * batches},
            f"int8 hub launches: {launches['int8 hub']}")
    require(not any(PLAIN_CALLS.values()),
            f"serving: plain versions ran on the card: {PLAIN_CALLS}")
    print(f"  launches on each serving path ({batches} batches each): "
          f"{launches}", flush=True)
    check_retrieval(embedder8, feats_int8, rng, "int8 hub")
    cos_hubs = mean_cosine(feats_bf16, feats_int8)
    print(f"  bf16 vs int8 hub: mean cosine {cos_hubs:.5f} (reported, not gated)",
          flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del embedder8, enc8

    phase("parity: 2 layers at full width, card (bf16, kernels) vs CPU (f32, plain)")
    cfg2 = dataclasses.replace(esm2.ESM2_SIZES["esm2_t33_650M"], num_layers=2)
    state2 = {k: v for k, v in enc.state_dict().items()
              if not k.startswith("transformer.layers.")
              or int(k.split(".")[2]) < 2}
    seqs = sample_seqs(8, np.random.RandomState(1))
    torch.set_num_threads(os.cpu_count() or 1)
    parity = {}
    for name, quant, tol in (("bf16", False, 0.999), ("int8", True, 0.99)):
        state = esm2.quantize_esm2_int8_tree(state2) if quant else state2
        outs = []
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            model = SequenceEncoder(cfg2, 1024, proj_type="mlp", quant_int8=quant,
                                    device=device, dtype=dtype)
            model.load_state_dict(state)
            outs.append(OneProtEmbedder(OneProtModel({"sequence": model}),
                                        buckets=BUCKETS).embed_sequences(seqs))
        parity[name] = mean_cosine(*outs)
        print(f"  {name} hub: card vs CPU mean cosine {parity[name]:.6f} "
              f"(gate >= {tol})", flush=True)
        require(parity[name] >= tol, f"{name} parity {parity[name]} < {tol}")

    phase("serving: ESM2-15B width (48 x 5120, 40 heads of 128), bf16")
    torch.cuda.empty_cache()
    wide, wide_state, wide_cfg = serve_wide_hub(smi, launches)
    torch.cuda.empty_cache()  # the hub's 30 GB go back before what follows

    phase("15B-width parity: 2 layers at full width, bf16 and int8, card "
          "(bf16, kernels) vs CPU (f32, plain)")
    wide["parity_mean_cosine"] = wide_hub_parity(wide_state, wide_cfg)
    del wide_state

    with tempfile.TemporaryDirectory(prefix="chip_smoke_msa_") as msa_dir:
        phase("serving: MSA-1b (esm_msa1b, 12 x 768), depth 16, batch 4, up "
              "to 1024 columns")
        # its own numpy stream, so that the training batch below stays the
        # one drawn from `rng` before this path was added
        msa, msa_state, msa_requests = serve_msas(
            msa_dir, torch.Generator(device="cuda").manual_seed(2),
            np.random.RandomState(2), smi, launches)

        phase("MSA parity: 2 layers at full width, card (bf16, kernel) vs CPU "
              "(f32, plain)")
        msa["parity"] = msa_parity(msa_state, msa_requests[0])

        phase("MSA-1b with use_all_msa=False: the query row pooled (mean), "
              "one request, then 2 layers card vs CPU")
        msa["query_row"] = serve_msas_query_row(msa_state, msa_requests, smi,
                                                launches)
    del msa_state

    phase("training: ESM2-650M hub + ESM2-35M struct-token tower, packed "
          "and cached steps")
    train, (hub_state, tower_state, tower_cfg), batch = training(enc, rng,
                                                                launches)

    phase("training parity: 2 + 2 layers at full width, card (bf16, kernels) "
          "vs CPU (f32, plain); cached vs uncached")
    train_parity = training_parity(hub_state, tower_state, enc.config,
                                   tower_cfg, batch)
    del embedder, enc, hub_state, tower_state
    torch.cuda.empty_cache()

    phase("trainer: Trainer.fit, ESM2-650M hub + ESM2-35M struct-token tower, "
          "packed rows through the feature cache, 2 epochs, then a resume for "
          "a third")
    trainer, trainer_initial, records = trainer_phase(
        smi, launches, train["cached"]["median_step_ms"])
    torch.cuda.empty_cache()

    phase("trainer parity: 2 + 2 layers at full width, 4 steps, card (bf16, "
          "kernels) vs CPU (f32, plain)")
    trainer["parity"] = trainer_parity(trainer_initial, records)
    trainer["parity_lr_1e-4"] = trainer_parity(trainer_initial, records,
                                               lr=1e-4)
    print(f"  trainer parity margins under the 2e-2 gate: Adam 1e-3 "
          f"{trainer['parity']['margin']:.2e}, Adam 1e-4 "
          f"{trainer['parity_lr_1e-4']['margin']:.2e}", flush=True)
    del trainer_initial, records

    phase("training: LoRA-15B (48 x 5120 frozen bf16, LoRA r 16 on q/k/v, "
          "remat) + ESM2-35M struct-token tower, unpacked steps, then packed "
          "steps (16 x 1024, 16 slots: #5-#7 with segment ids)")
    lora, lora_initial = train_lora_hub(smi, launches)
    torch.cuda.empty_cache()

    phase("LoRA training parity: 2 + 2 layers at full width, two steps, card "
          "(bf16, kernels) vs CPU (f32, plain), unpacked, then packed")
    lora["parity"] = lora_parity(*lora_initial)
    lora["packed_parity"] = lora_parity(*lora_initial, packed=True)
    del lora_initial
    torch.cuda.empty_cache()

    phase("cli: experiment=train_packed through cli.train.main, ESM2-650M hub "
          "+ ESM2-35M tower in bf16, 2 epochs and the test split, then a "
          "test-only run from last")
    cli = cli_phase(smi, launches)
    cli_rows = cli.pop("_rows")
    torch.cuda.empty_cache()

    phase("data-parallel (a): the cli run again in three children at once, "
          "two alone and one in a torchrun world of one over NCCL "
          "(trainer=ddp), deterministic algorithms on")
    data_parallel = {"world_of_one": ddp_world_of_one_phase(smi, launches,
                                                            cli_rows)}

    phase("data-parallel (b): two ranks over gloo on the one card, 650M hub "
          "+ 35M tower, halves of two packed batches of 16 x 1024: packed, "
          "cached and SigLIP-ring steps against this process on the whole "
          "rows")
    data_parallel["gloo"] = gloo_two_ranks_phase(smi, launches)
    torch.cuda.empty_cache()

    phase("tensor parallel (A): experiment=train_3b_tp at mesh.model 2 "
          "through cli.train.main, four gloo ranks on the one card (data 2 "
          "x model 2), the ESM2-3B hub at full width and depth; then one "
          "process at model 1 on both data ranks' rows")
    tensor_parallel = {"A": tensor_parallel_phase("A", smi, launches)}
    torch.cuda.empty_cache()

    phase("tensor parallel (B): experiment=train_packed "
          "data=struct_token_only at mesh.model 2, two gloo ranks, the "
          "trainable 35M tower split; its checkpoint restored at model 1")
    tensor_parallel["B"] = tensor_parallel_phase("B", smi, launches)
    torch.cuda.empty_cache()

    phase("text serving: embed_texts, BiomedBERT-base width (12 x 768), "
          "bf16, 3 requests of 32 texts; then 2 layers card vs CPU")
    text = {"kernels": text_kernels, "serving": text_serving(smi, launches)}
    torch.cuda.empty_cache()

    phase("text cli: experiment=seq_text through cli.train.main, ESM2-650M "
          "hub + BiomedBERT-base in bf16: CLIP 2 epochs + test (fully "
          "cached), LoRA + SigLIP 1 epoch, packed LoRA + SigLIP")
    text["cli"] = text_cli_phase(smi, launches)
    torch.cuda.empty_cache()

    phase("text parity: 2 hub + 2 BERT layers at full width, LoRA text, "
          "SigLIP, 2 steps, card (bf16, kernels) vs CPU (f32, plain)")
    text["parity"] = text_parity()
    torch.cuda.empty_cache()

    phase("graph tower: StructGraphEncoder at struct_graph.yaml's widths "
          "(ProNet 128 x 4, out 1024) on 1024 residues, then pocket.yaml's "
          "on 128, K=24, 3 requests of 16 from PDB text; card vs CPU")
    graph = graph_phase(smi, launches)
    torch.cuda.empty_cache()

    phase("seq<->msa and seqsim: Trainer.fit, ESM2-650M hub + esm_msa1b "
          "(depth 50), both cached, 2 epochs")
    msa_train = msa_seqsim_phase(smi, launches)
    torch.cuda.empty_cache()

    hub_root = tempfile.mkdtemp(prefix="chip_smoke_hub_")
    try:
        phase("pretrained hub: ESM2-650M as a local HF checkpoint (f32 "
              "safetensors), loaded int8 by cli.train.build_model with the "
              "int8 canary, then one request")
        t = time.time()
        pretrained = pretrained_hub_phase(
            os.path.join(hub_root, "esm2_t33_650M_UR50D"), smi, launches)
        pretrained["s"] = time.time() - t

        phase("the shipped default train.yaml through cli.train.main: "
              "ESM2-650M hub, ProNet struct_graph and pocket, BiomedBERT-base "
              "text, seqsim data; 2 epochs and the test split")
        default_cli = default_cli_phase(
            smi, launches, os.path.join(hub_root, "esm2_t33_650M_UR50D"))
    finally:
        shutil.rmtree(hub_root, ignore_errors=True)
    torch.cuda.empty_cache()

    phase("the f32 experiments as shipped through cli.train.main: "
          "debug_struct_token, train_packed, debug_all_modalities")
    f32_runs = f32_experiments_phase(smi, launches)

    for row in rows:
        # each path's count read from its own run; `launches` is their sum
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in launches.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    n_seq = sum(len(r) for r in requests)
    print(json.dumps({
        "serving": {"sequences": n_seq, "requests": len(requests),
                    "bf16_seq_per_s": n_seq / sum(secs_bf16),
                    "int8_seq_per_s": n_seq / sum(secs_int8),
                    "bf16_request_ms": [s * 1e3 for s in secs_bf16],
                    "int8_request_ms": [s * 1e3 for s in secs_int8],
                    "bf16_vs_int8_mean_cosine": cos_hubs,
                    "parity_mean_cosine": parity,
                    "peak_gib": peak_gb},
        "wide_hub_serving": wide,
        "msa_serving": msa,
        "training": {**train, "parity": train_parity},
        "trainer": trainer,
        "lora_training": lora,
        "cli": cli,
        "data_parallel": data_parallel,
        "tensor_parallel": tensor_parallel,
        "text": text,
        "graph": graph,
        "msa_seqsim_training": msa_train,
        "pretrained_hub": pretrained,
        "default_train_yaml": default_cli,
        "probes": default_cli.pop("probes"),
        "f32_experiments": f32_runs,
        "wall_s": time.time() - T0}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-child"]:  # the data-parallel phases' children
        exact_f32()
        sys.exit(cli_child(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--gloo-child"]:
        exact_f32()
        sys.exit(gloo_child(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--tp-child"]:
        exact_f32()
        sys.exit(tp_child(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
