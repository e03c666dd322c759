#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs one card
    python3 chip_smoke.py --k1-bwd-against DIR   # only K1's backward against DIR's
    python3 chip_smoke.py --k2-bwd-against DIR   # only K2's backward against DIR's
    python3 chip_smoke.py --k3-bwd-against DIR   # only K3's backward against DIR's
    python3 chip_smoke.py --sass-against DIR     # only K1's and K2's SASS against DIR's

Phases, each failing loudly (nonzero exit):
  1. print the card (nvidia-smi name, power limit) and the torch/CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
     source, all started together) into ``build/kernels``, printing each
     kernel's registers and spills (K1's bf16 kernels at head dims 112 and 256
     must be there, none spilling);
  3. hold every kernel against its plain PyTorch version on the card at the
     serving paths' shapes and the test sweeps', in f32 and bf16 (the two
     designs of K1 and K3; K1 at head dim 256 too, with and without a sliding
     window, at gemma3-12b's prefill shapes, and at 112, at zamba2-7b's, where it
     is also timed padded to 128 as the TPU route runs it; at 128 in
     qwen3-moe-235b-a22b's GQA 16:1 layout and phi4-mini-3.8b's 24:8, both ways;
     at the launcher train job's 8 x 64 tokens both ways; K3 at zamba2's too), K2
     through each of its four entry points (rmsnorm,
     add_rmsnorm, gated_rmsnorm, qk_norm_rope; rmsnorm and add_rmsnorm at
     llama-3.2-vision's width 8,192 too), and the SSD scan on the conv output's
     strided views; K1 not causal over Sq != Skv, both ways, as the
     cross-attending paths call it (Sq > Skv included: whisper's training
     cross-attention, 2,048 queries over 1,500 frames); time kernel, plain version
     and the PyTorch library call that computes the same function (F.rms_norm,
     SDPA; none for the fused norms and the SSD scan);
  4. serve each model of the port at full width through ``run_serve_task``
     (8 requests of 512 prompt + 32 new tokens, 4 slots, 2048-token cache):
     qwen3-0.6b (dense: K1, K2), mamba2-2.7b (ssm: K2, K3), gemma3-12b
     (dense, 5:1 local:global: K1 at head dim 256 with a 1,024-token window, K2,
     the ring cache), then zamba2-7b (hybrid, all 81 layers: K3, K2, and K1 at
     head dim 112 in its shared block), then deepseek-moe-16b (moe, all 28
     layers: K1, K2) and qwen3-moe-235b-a22b (moe, cut to 2 layers: K1 at GQA
     16:1, K2 with qk_norm_rope), whisper-medium (encdec, all 24 + 24 layers:
     K1 not causal in the encoder and the cross-attention, K2) and
     llama-3.2-vision-90b (vlm, cut to 10 layers: K1 with GQA 8:1, K2 at 8,192),
     each with the launch counters set to 0 just before and read just after
     (every kernel exactly so many a prefill and a decode step), and the previous
     server released first. Then check
     prefill + one decode step against ``forward`` at full width (f32 to 1e-4
     at every layer, gemma3 at 6, deepseek at 8, llama at 5; bf16 at 0.08 at 4
     layers, gemma3 at 6, llama at 5; whisper and llama on random frames and
     patches with every gate at CROSS_GATE; the MoE paths at a capacity where no
     assignment can be
     dropped, the drops at 1.25 and 8.0 counted from the routing; see
     ``phase_serve``), time prefill, decode and the warm task, and profile one
     prefill and one decode step (kernels per call, each held at its known
     count; device busy; K2's device time a launch); gemma3 also serves one
     2,048-token prompt (2W: every decode step wraps the ring) and profiles
     its prefill;
  5. the backward kernels (K1's, and K2's for rmsnorm, add_rmsnorm and
     qk_norm_rope, one launch each with dscale folded in) against their plain
     versions on the card in f32 and bf16,
     the forward's LSE against the plain LSE, two runs of each bit-equal; then
     time each beside its bound, its plain version and a library yardstick
     (SDPA's and F.rms_norm's backward), K1's at B=1 and at the training shape;
     K1's at head dim 256 too, over the forward's D=256 sweep and at gemma3-12b's
     training shapes (S=2048, with and without the 1,024-token window), timed
     there beside SDPA's backward (its backend printed); at head dim 112 over its
     sweep and at zamba2-7b's training shape (S=2048, H=K=32), timed there; at
     head dim 128 in qwen3-moe's 64:4 layout, timed at S=2048;
     then the ssm slice's (K3's backward on the SSD sweep, its own shapes and
     the training shape, with and without init_state and d(final state), on the
     conv output's views too; gated_rmsnorm's), timed at mamba2-2.7b's training
     shape (no library call for either);
  6. one train step in f32 on the card against the same step on the CPU (loss,
     grad_norm, m, master; every leaf gets a nonzero gradient): qwen3-0.6b and
     mamba2-2.7b at full width, 2 layers; gemma3-12b at its attention shape
     (16 q / 8 kv heads of 256, window 1,024), 6 layers, with d_model, d_ff and
     the vocabulary narrowed, on 1,100 tokens; zamba2-7b at its attention shape
     (32 heads of 112), 9 layers (one group and the tail), narrowed so, on 600;
     deepseek-moe-16b at its attention and expert layout (16 heads of 128; 64
     experts, top-6, 2 shared), 4 layers, d_model, the experts' width and the
     vocabulary narrowed, on 600 tokens, its routers' top-k picks on the card
     and the CPU exactly equal at every layer; whisper-medium at full width, 2
     encoder and 2 decoder layers, on 600 tokens over 1,500 frames;
     llama-3.2-vision-90b at its attention shape (64 q / 8 kv heads of 128), one
     group of 5 layers, d_model, d_ff and the vocabulary narrowed, on 600
     tokens over 1,601 patches, its gates at CROSS_GATE; then one f32 local-SGD round of
     qwen3-0.6b at full width and 2 layers (2 pods, H = 2, int8 compression on
     and off) on the card against the CPU's (``phase_local_sgd_parity``);
  7. train qwen3-0.6b at full width and depth, bf16, through ``run_train_task``
     (4 steps of 4 x 2048 tokens, a checkpoint every 2 steps), with the launch
     counters set to 0 just before and read just after; evaluate it through a
     strict ``run_eval_task`` restore; time warm steps, profile one, and check
     one step of 2 microbatches against the first step's loss; then
     (``phase_local_plane``) make the control agent's calls on the port's
     local planes: the same job (6 steps, a checkpoint every 4) on plane A,
     lost after its step-4 manifest, resumed on plane B from it, its losses an
     uninterrupted run's bit for bit; the ``eval`` handler's strict restore of
     step 6; a serve job on B whose tokens are a direct ``Server.run``'s; one
     profiled train poll; the etl -> train -> eval -> export chain through one
     worker's warm handlers, eval a cache hit; the counters read around the
     plane's train and serve jobs (the path "qwen3-0.6b plane"); then
     (``phase_launchers``) the port's entry points as a user runs them:
     ``repro_torch.launch.train`` in its default driver mode (the port's own
     management plane, a master and 2 private clusters, 30 steps of 8 x 64
     tokens, checkpoints at 25 and 30) and with ``--direct``, the losses bit-equal;
     ``launch.serve`` direct and ``--driver``, the tokens equal; the counters read
     around the four runs (the path "qwen3-0.6b launchers"); the host ms of a
     ``plane.tick()`` outside the local planes' calls and the job's seconds from
     submit to done; ``examples/torch_quickstart.py`` and
     ``examples/torch_hybrid_pipeline.py``; then (``phase_phi4``) phi4-mini-3.8b
     through the serve launcher's direct mode at full width and depth, the
     counters exact (the path "phi4-mini-3.8b launcher"), and its prefill + one
     decode step against forward (f32 at every layer, bf16 at 4);
  8. train mamba2-2.7b at full width and depth, bf16, through ``run_train_task``
     (2 steps of 2048 tokens), the counters read around it (every K2 and K3
     entry of the path, exactly so many a layer a step); time warm steps and
     profile one (K3's backward kernels, each at the training shape, by launch);
     then its train task (4 steps, a checkpoint every 2) and a
     strict eval-task restore at full width and 4 layers (a 64-layer save is
     ~39.6 GB);
  9. train gemma3-12b at full width, cut to one local:global group of 6 layers,
     then zamba2-7b at full width, cut to two groups and the tail (15 layers),
     then deepseek-moe-16b at full width, cut to 4 layers (its aux loss finite
     and within a load-balance loss's range at step 1), bf16, through ``run_train_task``
     (2 steps of one 2,048-token sequence), the counters read around it (every
     K1, K2 and K3 entry, exactly so many a step); time 3 warm steps and profile
     one (each of K1's backward kernels at the path's head dim, 256, 112 or 128,
     once an attention layer, no other K1 backward kernel). No checkpointed
     task: saves at these depths are ~22-47 GB, and the task code is the same as
     qwen3's and mamba2's. Then whisper-medium at full width and depth the same
     way (4 x 2,048 tokens over the Trainer's 4 x 1,500 frames; K1 72 times a
     step each way, at head dim 64), and its checkpointed task (2 steps, a
     checkpoint every 2; ~14 GB a save) and a strict eval-task restore;
 10. train qwen3-0.6b at full width and depth in local_sgd mode (the Titchener
     mode: 2 pods, H = 4 inner steps a round, 2 x 2048 tokens a pod, bf16)
     through ``run_train_task`` (8 steps, 2 rounds), the counters read around it
     (every K1 and K2 entry, exactly so many a pod-step), every pod's params
     bit-equal to the master after each round; time 3 warm rounds and the outer
     step alone, profile one of each, print the bytes a round crosses the pod
     boundary; then its checkpointed task (8 steps, a checkpoint every 8) and a
     strict eval-task restore at full width and 4 layers (a 28-layer save is
     30.8 GiB);
 11. the cells (``repro_torch.launch.steps.build_cell``) at qwen3-0.6b's full
     width and depth, cut in batch (see ``CELLS_ARCH``): train_4k one step under
     remat none, full and dots from one state and batch (loss, grad_norm and
     params bit-equal; peak memory full < dots < none; launches exact),
     prefill_32k (K1 at S = 32,768 against its plain version in f32 and bf16,
     timed beside its bound and SDPA; the logits against forward's last
     position, a wiring check), decode_32k (16 steps on the prefill's cache) and
     the Titchener round; the dry-run of the train cell (``roofline/op_stats.py``
     on fake tensors, in a CPU process started after the build on a core that
     the script then leaves to it) beside the card's peak and step; mamba2-2.7b's long_500k cell (its decode in f32 at 4
     layers against the prefill); ``examples/torch_train_100m.py --steps 300``.

The last three lines of standard output are the card line, one JSON object with
each kernel's numbers, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside a checkout, it exits nonzero and prints no result.

``--k1-bwd-against DIR`` runs phases 1-2, then only K1's backward against the one
of the checkout at DIR (built from DIR's source into a library of its own): f32
results bit-equal over the check sweep, bf16 results of both within the gate
(and how many bit-equal), and the bf16 times of both in turns (DIR's, this,
this, DIR's); at head dim 256 too, where DIR's has it.
``--k2-bwd-against DIR`` does the same for K2's three backward entry points (f32
dx bit-equal; every output of both within the gate), and profiles each design
once at the training shapes, kernel by kernel. ``--k3-bwd-against DIR`` does the
same for K3's backward (f32 results bit-equal over the backward sweep; bf16 of both
within the gate; bf16 times in turns at the training shape; both designs profiled
by kernel). ``--sass-against DIR`` checks that every kernel of DIR's
``csrc/flash_attention.cu`` and ``csrc/rmsnorm.cu`` compiles to the same SASS here
(``cuobjdump -sass``) and names the kernels this checkout adds and any that
differ. The flags may be given together.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16  # noqa: E402

# H100 SXM published peaks (dense): HBM bytes/s; flop/s by the type of the work
PEAK_BYTES_S = HBM_BW
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16,   # tensor cores, bf16 inputs
              torch.float32: 67e12}              # CUDA cores, f32 without TF32

# ``profile_breakdown``'s window: a pause at each end, and sentinel kernels
# (``torch.cuda._sleep``, ~10 us each) before the profiled call; tries a call. 64
# sentinels: one host lost all of 16 in three tries in a row of a training profile
PROFILE_PAUSE_S, PROFILE_TRIES = 0.1, 3
SPINS, SPIN_CYCLES, SPIN_KERNEL = 64, 20_000, "spin_kernel"

SERVE = {"reduced": False, "slots": 4, "max_len": 2048, "n_requests": 8,
         "prompt_len": 512, "max_new": 32}
# capacity factors whose drops are counted in the MoE checks' routing: the configs'
# and the JAX suite's (tests/test_models_smoke.py:74-79)
MOE_CAPACITIES = (1.25, 8.0)
# One serving path per ported family, at full width. ``launches``: each forward
# kernel's launches in every prefill (B = 1, the served prompt) and in every decode
# step, (prefill, decode), held exactly over the serve task; every kernel not
# named launches no time (rmsnorm: ln1 of the first layer of a stack; add_rmsnorm:
# every other norm, each with the residual add before it, the final norm and
# whisper's enc_norm included; qk_norm_rope once a layer; gated_rmsnorm once a
# mamba2 layer; K1 and K3 once an attention or mamba2 layer of a prefill, never in
# a decode step: decode attends to the cache in plain PyTorch). ``f32_leaves``:
# params kept in f32.
# ``toks``: the (batch, length) of each prefill + decode vs forward check; 601
# makes mamba2's 600-token prefill cross two 256-token chunks and end ragged, and
# gemma3's stay inside its 1,024-token window (the ring padded); 2049 fills
# gemma3's ring from a 2W prefill and wraps it with the decode step.
# ``check_layers``: the depth of the f32 check (None: every layer; gemma3: one
# local:global group, since an f32 copy of all 48 layers would take ~51 GB beside
# the 25.5 GB of bf16 params) and of the bf16 check at the JAX suite's 0.08 (see
# ``phase_serve``); ``deep_prefill_tol``: the gate of the bf16 prefill at full depth
# (None: printed only). ``long_prompt``: a served prompt of that many tokens, then
# ``max_new`` - 1 decode steps (gemma3: 2W, so every decode step writes over the
# ring's oldest slot).
# ``kernels``: the kernels of one profiled prefill (512 tokens; "prefill long": the
# long prompt) and decode step (4 slots), every one of them counted (see
# ``profile_breakdown`` for how its window is kept whole). mamba2's were held at
# 2,629 and 3,459 until the profiler's window was repaired: those counts had lost
# the call's first kernel, the embedding gather; the same serving code counts 2,630
# and 3,460 in a whole one. gemma3's were counted on the card when its path was
# added (a 512-token prefill pads its 40 rings to W; a 2,048-token one takes views),
# and zamba2-7b's, the MoE paths' and the cross-attending paths' likewise. zamba2-7b
# (hybrid): 81 mamba2 layers, the shared
# attention block after every 6th (13 times; K1 at head dim 112, no qk-norm), a
# tail of 3; its f32 check at every layer (27 GB of f32 params beside 12.6 of
# bf16), bf16 at one group and the tail (9 layers). The MoE family: deepseek-moe-16b
# at full width and depth (28 layers, 64 routed experts of 1408 and 2 shared, top-6,
# MHA 16/16; 31.44 GiB of bf16), its f32 check at 8 layers (28 in f32 are ~63 GiB);
# qwen3-moe-235b-a22b at full width, cut to ``layers`` = 2 (128 experts of 1536,
# top-8, GQA 64:4, qk-norm; its 94 layers are ~438 GiB of bf16), both checks at both
# layers. Their prefill + decode vs forward checks run at ``no_drop_capacity``, where
# a group's capacity reaches its S tokens: prefill's and forward's dispatch then drop
# no assignment that decode's dense all-experts path keeps (at the JAX suite's 8.0
# random full-width routers overfill experts: ``routing_drops``). The serve task
# runs the configs' 1.25. The cross-attending families: whisper-medium (encdec) at
# full width and depth (24 encoder layers over 1,500 frames, not causal, run at
# prefill only; 24 decoder layers, each causal self-attention then cross-attention
# onto the encoder's output; MHA 16/16 of 64; 1.89 GiB of bf16), its f32 check at
# every layer, bf16 at 4 decoder layers; llama-3.2-vision-90b (vlm) at full width,
# cut to ``layers`` = 10 (two groups of 4 self layers and a tanh-gated cross layer
# onto 1,601 patches; GQA 64:8 of 128, d_model 8,192; 19.85 GiB of bf16; its 100
# layers are 163.3 GiB), both checks at one group (10 f32 layers are ~40 GiB). The
# servers feed zero frames and patches (the JAX package's stubs) and the gates are
# 0 at init, so the checks against forward draw random frames and patches and set
# every gate to ``CROSS_GATE``.
PATHS = [
    {"arch": "qwen3-0.6b", "params": 751_632_384, "f32_leaves": (), "toks": [(2, 64)],
     "check_layers": (None, 4), "deep_prefill_tol": 0.08,
     "launches": {"flash_attention": (28, 0), "rmsnorm": (1, 1), "add_rmsnorm": (56, 56),
                  "qk_norm_rope": (28, 28)},
     "kernels": {"prefill": 432, "decode": 1_265}},
    {"arch": "mamba2-2.7b", "params": 2_830_951_936, "f32_leaves": ("a_log", "dt_bias"),
     "toks": [(2, 601)], "check_layers": (None, 4), "deep_prefill_tol": 0.08,
     "launches": {"ssd_scan": (64, 0), "rmsnorm": (1, 1), "add_rmsnorm": (64, 64),
                  "gated_rmsnorm": (64, 64)},
     "kernels": {"prefill": 2_630, "decode": 3_460}},
    {"arch": "gemma3-12b", "params": 12_772_052_736, "f32_leaves": (),
     "toks": [(2, 601), (1, 2049)], "check_layers": (6, 6), "deep_prefill_tol": None,
     "long_prompt": 2048,
     "launches": {"flash_attention": (48, 0), "rmsnorm": (1, 1), "add_rmsnorm": (96, 96),
                  "qk_norm_rope": (48, 48)},
     "kernels": {"prefill": 902, "decode": 2_421, "prefill long": 838}},
    {"arch": "zamba2-7b", "params": 6_750_539_856, "f32_leaves": ("a_log", "dt_bias"),
     "toks": [(2, 601)], "check_layers": (None, 9), "deep_prefill_tol": None,
     "launches": {"flash_attention": (13, 0), "ssd_scan": (81, 0), "rmsnorm": (1, 1),
                  "add_rmsnorm": (80 + 2 * 13 + 1, 80 + 2 * 13 + 1),
                  "gated_rmsnorm": (81, 81)},
     "kernels": {"prefill": 4_255, "decode": 5_687}},
    {"arch": "deepseek-moe-16b", "params": 16_879_568_896, "f32_leaves": (),
     "toks": [(2, 601)], "check_layers": (8, 4), "deep_prefill_tol": 0.08,
     "launches": {"flash_attention": (28, 0), "rmsnorm": (1, 1), "add_rmsnorm": (56, 56)},
     "kernels": {"prefill": 3_146, "decode": 3_000}},
    {"arch": "qwen3-moe-235b-a22b", "layers": 2, "params": 6_220_173_824, "f32_leaves": (),
     "toks": [(2, 601)], "check_layers": (None, None), "deep_prefill_tol": 0.08,
     "launches": {"flash_attention": (2, 0), "rmsnorm": (1, 1), "add_rmsnorm": (4, 4),
                  "qk_norm_rope": (2, 2)},
     "kernels": {"prefill": 153, "decode": 135}},
    # whisper: a prefill runs the encoder (24 layers, K1 not causal over the 1,500
    # frames; ln1 of its layer 0, 47 adds + norms, enc_norm) and the decoder (24
    # causal self and 24 cross K1 launches; ln1 of its layer 0, ln3 and ln2 a layer,
    # 23 more ln1, the final norm); a decode step only the decoder's norms
    {"arch": "whisper-medium", "params": 1_012_314_112, "f32_leaves": (),
     "toks": [(2, 601)], "check_layers": (None, 4), "deep_prefill_tol": 0.08,
     "launches": {"flash_attention": (72, 0), "rmsnorm": (2, 1),
                  "add_rmsnorm": (48 + 72, 72)},
     "kernels": {"prefill": 2_655, "decode": 2_452}},
    # llama-3.2-vision at 10 layers: 8 causal self and 2 cross K1 launches a prefill;
    # ln1 of layer 0, then 2 a layer but the first's ln1, and the final norm
    {"arch": "llama-3.2-vision-90b", "layers": 10, "params": 10_657_898_498,
     "f32_leaves": (), "toks": [(2, 601)], "check_layers": (5, 5), "deep_prefill_tol": 0.08,
     "launches": {"flash_attention": (10, 0), "rmsnorm": (1, 1), "add_rmsnorm": (20, 20)},
     "kernels": {"prefill": 486, "decode": 743}},
]
# every vlm cross layer's gate in the checks against forward (0 at init, where the
# cross layer adds nothing)
CROSS_GATE = 0.5
# twins of tests/test_kernels.py:FLASH_SWEEP: B, S, H, K, D, causal, window
FLASH_SWEEP = [(1, 128, 4, 4, 64, True, 0), (2, 256, 4, 2, 64, True, 0),
               (1, 256, 8, 1, 32, True, 0), (1, 128, 4, 4, 64, False, 0),
               (1, 256, 4, 2, 64, True, 64), (1, 96, 2, 2, 80, True, 0)]
# twins of tests/test_torch_kernels.py:SHORT_Q: B, Sq, Skv, H, K, D, causal, window
SHORT_Q = [(1, 32, 96, 4, 2, 64, True, 0), (2, 17, 80, 4, 1, 32, True, 24),
           (1, 40, 72, 2, 2, 80, False, 0)]
# K1's forward at head dim 256 (gemma3-12b): B, Sq, Skv, H, K, causal, window. Causal
# with and without a window, GQA 2:1 and 1:1, ragged S (1000), Sq < Skv with and
# without a window, and not causal
FLASH_256_SWEEP = [(1, 128, 128, 4, 4, True, 0), (2, 256, 256, 4, 2, True, 64),
                   (1, 1000, 1000, 4, 2, True, 0), (1, 1000, 1000, 2, 1, True, 300),
                   (1, 96, 200, 4, 2, True, 0), (2, 40, 130, 4, 2, True, 48),
                   (1, 130, 130, 4, 2, False, 0)]
# gemma3-12b's prefill attention (B=1, H=16, K=8, D=256, causal): (S, window) of a
# global layer (0) and a local one (1024), at the served prompt and at 2W
GEMMA_ATTN = [(512, 0), (512, 1024), (2048, 0), (2048, 1024)]
# K1 at head dim 112 (zamba2-7b's shared block): B, Sq, Skv, H, K, causal, window.
# Causal MHA (H = K, as zamba2), GQA 2:1, ragged S (1000), Sq < Skv, not causal,
# and zamba2's 512-token prefill (its 2,048-token one is ZAMBA_ATTN's and the
# backward's timed shape)
FLASH_112_SWEEP = [(1, 256, 256, 4, 4, True, 0), (2, 256, 256, 4, 2, True, 0),
                   (1, 1000, 1000, 4, 2, True, 0), (1, 96, 200, 4, 2, True, 0),
                   (2, 40, 130, 4, 4, True, 48), (1, 130, 130, 4, 4, False, 0),
                   (1, 512, 512, 32, 32, True, 0)]
# zamba2-7b's prefill attention (B=1, H=K=32, D=112, causal) at S = 512 and 2,048
ZAMBA_ATTN = [512, 2048]
# K1 at the MoE paths' layouts, both ways: qwen3-moe-235b-a22b's GQA 16:1 (H=64, K=4,
# D=128, causal), a ragged case, and deepseek-moe-16b's served prompt (MHA 16/16) in
# the sweep (B, Sq, Skv, H, K, causal, window); 16:1's timed shapes (B, S, H, K,
# window): the served prompt and S=2,048 forward, S=2,048 backward
MOE_ATTN_SWEEP = [(1, 200, 200, 64, 4, True, 0), (1, 512, 512, 16, 16, True, 0)]
MOE_ATTN = [(1, 512, 64, 4, 0), (1, 2048, 64, 4, 0)]
# K1 as the cross-attending paths call it, not causal (B, Sq, Skv, H, K, D), both
# ways: small cases (twins of tests/test_torch_kernels.py's SHORT_Q cross cases: Sq >
# Skv and ragged, Sq < Skv at GQA 8:1), then whisper-medium's cross-attention (512
# queries over 1,500 frames), its encoder (1,500 over 1,500), its training
# cross-attention (4 x 2,048 queries over 1,500 frames: Sq > Skv) and
# llama-3.2-vision-90b's (512 over 1,601 patches, GQA 64:8 of 128); those four are
# timed both ways beside their bound and SDPA
CROSS_ATTN_SWEEP = [(2, 96, 40, 4, 2, 64), (1, 130, 70, 4, 4, 64), (1, 40, 75, 8, 1, 128)]
CROSS_ATTN = [(1, 512, 1500, 16, 16, 64), (1, 1500, 1500, 16, 16, 64),
              (4, 2048, 1500, 16, 16, 64), (1, 512, 1601, 64, 8, 128)]
# K1's self-attention at those paths' other shapes (B, Sq, Skv, H, K, D, causal, and
# whether the backward runs there too): whisper-medium's causal decoder at its
# served prompt and in training (4 x 2,048, both ways), its encoder in training (4 x
# 1,500, not causal, both ways), llama-3.2-vision-90b's causal self layers at its
# served prompt (GQA 64:8 of 128); checked and timed as CROSS_ATTN's shapes are
SELF_ATTN = [(1, 512, 512, 16, 16, 64, True, False),
             (4, 2048, 2048, 16, 16, 64, True, True),
             (4, 1500, 1500, 16, 16, 64, False, True),
             (1, 512, 512, 64, 8, 128, True, False)]
# those outputs are small (not causal over ~1,500 keys an output element of randn
# inputs has a std of ~sqrt(e / Skv) ~ 0.04, dV less), where TOL's and
# FLASH_GRAD_TOL's absolute terms alone would pass an error of half a value: each
# output is also held at ``rms_tol`` (the values' RMS as the unit of the absolute
# term), by dtype and direction. In two runs on an H100 the largest were 5.5e-6
# and 1.0e-5 in f32, 6.8e-3 and 5.8e-2 in bf16 (forward, backward; the bf16
# backward's at the causal 4 x 2,048); the gates leave 2.5x or more over them. The
# plain version that loses even one key of a ragged kv tail measures 0.71 or more
# at every CROSS_ATTN shape
RMS_UNIT_TOL = {(torch.float32, "fwd"): 5e-5, (torch.float32, "bwd"): 5e-5,
                (torch.bfloat16, "fwd"): 2e-2, (torch.bfloat16, "bwd"): 0.15}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# K2's check sweep: twins of tests/test_torch_kernels.py's rmsnorm shapes and more
RMS_SWEEP = [(3, 5, 80), (2, 64, 128), (1, 7, 256), (4, 1, 512), (2, 16, 1024),
             (4 * 1024, 1024), (1, 2048, 16, 128), (4, 1, 5120), (1, 2048, 3584),
             (1, 2048, 7168)]
# K2's serving shapes at the MoE paths' widths: deepseek-moe-16b's d_model 2048 and
# qwen3-moe-235b-a22b's 4096, a 512-token prefill and a decode step of 4 slots
MOE_NORM = [(1, 512, 2048), (4, 1, 2048), (1, 512, 4096), (4, 1, 4096)]
# and at the cross-attending paths': llama-3.2-vision-90b's d_model 8,192 (the widest
# row K2 normalises) at a prefill and a decode step, whisper-medium's encoder rows
CROSS_NORM = [(1, 512, 8192), (4, 1, 8192), (1, 1500, 1024)]
QWEN3_THETA = 1e6
# kernel names of K2 in profiler traces (csrc/rmsnorm.cu's two kernels)
K2_KERNEL_NAMES = ("rows_kernel", "qk_norm_rope_kernel")
# twins of tests/test_kernels.py:SSD_SWEEP (B, S, H, P, N, chunk), at its tolerances
SSD_SWEEP = [(1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 32, 64), (1, 100, 2, 32, 16, 32)]
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
SSD_MAIN = (1, 512, 80, 64, 128, 256)   # mamba2-2.7b prefill of 512 tokens
SSD_ZAMBA = (1, 512, 112, 64, 64, 256)  # zamba2-7b prefill of 512 tokens

# training: qwen3-0.6b at full width and depth, bf16, 8,192 tokens a step
TRAIN = {"arch": "qwen3-0.6b", "reduced": False, "seq_len": 2048, "global_batch": 4,
         "microbatches": 1, "steps": 4, "checkpoint_every": 2}
TRAIN_PATH = "qwen3-0.6b train"
# the plane phase: TRAIN's job driven through two TorchLocalPlanes (6 steps, a
# manifest at 4 and at 6), a serve job of src/repro/launch/serve.py's 8 prompts,
# and the pipeline DAG's worker side (train: 2 steps, no checkpoint; eval: the
# step-6 manifest)
PLANE_PATH = "qwen3-0.6b plane"
PLANE_CAPS = ("gpu", "train", "serve")
PLANE_TRAIN = dict(TRAIN, steps=6, checkpoint_every=4)
PLANE_SERVE = {"arch": "qwen3-0.6b", "reduced": False, "slots": 4,
               "requests": [{"prompt": [1 + (i % 7), 2, 3 + i % 5] + [4] * (i % 4),
                             "max_new": 16} for i in range(8)]}
PLANE_DAG_TRAIN = dict(TRAIN, steps=2)
# the plane serve job's prefills (one prompt of 3 to 6 tokens each): K1 at B=1, H=16,
# K=8, D=128, causal over a single partial tile (B, S, H, K, D, causal, window), and
# K2 at those rows of width 1,024 and those q/k heads
PLANE_LENS = sorted({len(r["prompt"]) for r in PLANE_SERVE["requests"]})
PLANE_ATTN = [(1, S, 16, 8, 128, True, 0) for S in PLANE_LENS]
PLANE_NORM = [(1, S, 1024) for S in PLANE_LENS]
PLANE_QK = [(1, S, 16, 8, 128) for S in PLANE_LENS]
# the launcher phase: ``python -m repro_torch.launch.train`` with its defaults (driver
# mode: a master and 2 private clusters; 30 steps of 8 x 64 tokens; qwen3-0.6b at full
# width and depth on the card), then ``--direct``; ``launch.serve`` with its defaults
# (6 requests of 8 new tokens, 4 slots, a 128-token cache) direct and ``--driver``
LAUNCH_PATH = "qwen3-0.6b launchers"
LAUNCH_STEPS, LAUNCH_BATCH, LAUNCH_SEQ = 30, 8, 64
LAUNCH_REQUESTS = 6
LAUNCH_LENS = sorted({len([1 + (i % 7), 2, 3 + i % 5] + [4] * (i % 4))
                      for i in range(LAUNCH_REQUESTS)})
# K1 and K2 at the launcher train job's shapes (the serve prompts' 3-6 tokens are
# PLANE_LENS's): B=8 sequences of 64 tokens, H=16, K=8, D=128, causal
LAUNCH_ATTN = [(LAUNCH_BATCH, LAUNCH_SEQ, 16, 8, 128, True, 0)]
LAUNCH_NORM = [(LAUNCH_BATCH, LAUNCH_SEQ, 1024)]
LAUNCH_QK = [(LAUNCH_BATCH, LAUNCH_SEQ, 16, 8, 128)]
# phi4-mini-3.8b through the serve launcher's direct mode at full width and depth
# (32 layers, d_model 3,072, GQA 24:8 of 128, no qk-norm; 8.9 GB of bf16), its checks
# against forward as ``phase_serve``'s (f32 at every layer, bf16 at 4)
PHI4_PATH = {"arch": "phi4-mini-3.8b", "params": 4_450_618_368, "f32_leaves": (),
             "toks": [(2, 64)], "check_layers": (None, 4), "deep_prefill_tol": None,
             "launches": {"flash_attention": (32, 0), "rmsnorm": (1, 1),
                          "add_rmsnorm": (64, 64)}}
PHI4_LAUNCH_PATH = "phi4-mini-3.8b launcher"
# K1 at phi4's GQA 24:8: its served prompts (3-6 tokens), a ragged 200 and B=2, both
# ways; timed at a 512-token prompt; K2 at its width at the prompts and decode steps
PHI4_ATTN_SWEEP = ([(1, S, S, 24, 8, True, 0) for S in LAUNCH_LENS]
                   + [(1, 200, 200, 24, 8, True, 0), (2, 64, 64, 24, 8, True, 0)])
PHI4_ATTN = [(1, 512, 24, 8, 0)]
PHI4_NORM = [(1, S, 3072) for S in LAUNCH_LENS] + [(4, 1, 3072)]


def dense_per_step(layers: int, qk_norm: bool = True) -> dict:
    """K1 and K2 launches in each dense (or MoE) train step of ``layers`` layers,
    forward and backward alike (rmsnorm: ln1 of layer 0; add_rmsnorm: every other
    norm, the final one included; qk_norm_rope once a layer where the arch has
    qk-norm)."""
    per = {"flash_attention": layers, "flash_attention_bwd": layers, "rmsnorm": 1,
           "rmsnorm_bwd": 1, "add_rmsnorm": 2 * layers, "add_rmsnorm_bwd": 2 * layers}
    if qk_norm:
        per.update(qk_norm_rope=layers, qk_norm_rope_bwd=layers)
    return per


TRAIN_PER_STEP = dense_per_step(28)
# K1's backward check sweep: the forward's sweep, its Sq < Skv cases, qwen3's D=128,
# and D=128 with Sq < Skv, ragged lengths and a window (the masks at qwen3's width)
FLASH_BWD_SWEEP = ([(B, S, S, H, K, D, c, w) for B, S, H, K, D, c, w in FLASH_SWEEP]
                   + SHORT_Q + [(2, 200, 200, 16, 8, 128, True, 0),
                                (1, 200, 328, 16, 8, 128, True, 128)]
                   + [(B, S, S, H, K, D, c, w) for B, S, H, K, D, c, w in LAUNCH_ATTN])
# K1's backward timed at (B, S), H=16, K=8, D=128, bf16, causal: qwen3's serving
# prompt and S=2048 at B=1 (the JSON row), and the training shape (4 x 2048)
FLASH_BWD_TIMED = [(1, 512), (1, 2048), (4, 2048)]
# the JAX suite's flash-gradient tolerance for f32 (tests/test_kernels.py:71); bf16
# gradients are rounded to bf16 once, held at the forward's bf16 tolerance
FLASH_GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# K2's backward check sweeps: the forward's, the training shapes (qwen3-0.6b's,
# gemma3-12b's and deepseek-moe-16b's), and the edges of the one-launch dscale fold: one row; rows fewer
# than blocks; rows not a multiple of a block's; wide rows (a block a row); one
# token of qwen3's q and k
GEMMA_NORM_BWD, GEMMA_QK_BWD = (1, 2048, 3840), (1, 2048, 16, 8, 256)
ZAMBA_NORM_BWD = (1, 2048, 3584)     # in RMS_SWEEP, as zamba2's gated (1, 2048, 7168)
MOE_NORM_BWD = (1, 2048, 2048)       # deepseek-moe-16b's
WHISPER_NORM_BWD = (4, 1500, 1024)   # whisper-medium's encoder in training
NORM_BWD_SWEEP = RMS_SWEEP + [(4, 2048, 1024), GEMMA_NORM_BWD, MOE_NORM_BWD, (1, 1, 1024),
                              (600, 1024), (2, 3, 2560), WHISPER_NORM_BWD, *LAUNCH_NORM]
QK_BWD_SWEEP = [(2, 12, 4, 2, 64), (3, 5, 2, 1, 128), (1, 7, 4, 2, 256), (4, 2048, 16, 8, 128),
                GEMMA_QK_BWD, (1, 1, 16, 8, 128), *LAUNCH_QK]
# kernel names of the backward kernels in profiler traces
K1_BWD_NAMES = ("bwd_delta_kernel", "bwd_dq_bf16_kernel", "bwd_dkdv_bf16_kernel")
K2_BWD_NAMES = ("rows_bwd_kernel", "qk_norm_rope_bwd_kernel")
# K2's backward entry points: one launch each, dscale folded in
K2_BWD_ENTRIES = ("rmsnorm_bwd", "add_rmsnorm_bwd", "qk_norm_rope_bwd")

# training the ssm family: mamba2-2.7b at full width and depth (64 layers), bf16,
# one sequence of 2,048 tokens a step
SSM_TRAIN = {"arch": "mamba2-2.7b", "reduced": False, "seq_len": 2048, "global_batch": 1,
             "microbatches": 1}
SSM_TRAIN_PATH = "mamba2-2.7b train"


def ssm_per_step(layers: int) -> dict:
    """K2 and K3 launches in each mamba2 train step of ``layers`` layers, forward
    and backward alike (rmsnorm: ln1 of layer 0; add_rmsnorm: every other norm,
    the final one included)."""
    return {"ssd_scan": layers, "ssd_scan_bwd": layers, "gated_rmsnorm": layers,
            "gated_rmsnorm_bwd": layers, "add_rmsnorm": layers, "add_rmsnorm_bwd": layers,
            "rmsnorm": 1, "rmsnorm_bwd": 1}


SSM_TRAIN_PER_STEP = ssm_per_step(64)
# the train and eval tasks' depth: a 64-layer checkpoint is ~39.6 GB, 4 layers ~5.8 GB
SSM_TASK_LAYERS = 4
# K3's backward: the check sweep (with and without init_state and d(final state))
# and the training shape, at which it is timed
SSD_BWD_MAIN = (1, 2048, 80, 64, 128, 256)
# shapes the backward alone is checked at (tests/test_torch_ssm_train.py:SSD_BWD_SHAPES):
# a ragged S, H not a multiple of the bf16 design's 10 heads a block, zamba2's N = 64
SSD_BWD_SHAPES = [(1, 200, 14, 64, 128, 256), (2, 130, 6, 64, 64, 256)]
# zamba2-7b's training scan: H=112, N=64 over 2,048 tokens
SSD_BWD_ZAMBA = (1, 2048, 112, 64, 64, 256)
SSD_BWD_SWEEP = SSD_SWEEP + SSD_BWD_SHAPES + [SSD_BWD_MAIN, SSD_BWD_ZAMBA]
# gates of K3's backward against the plain version evaluated in f64: relative, plus
# a share of the gradient's largest element (each element sums S-long runs of terms
# of that size, in another order and chunking); bf16 within one bf16 rounding of
# the output, with margin. dA sums B*S terms that cancel: f32 evaluations of it,
# the plain version's own, miss the f64 value by up to 1.5x the f32 gate (40 seeds
# of the sweep), so dA is held at SSD_DA_TIMES the plain version's distance from
# the f64 value, plus the share.
SSD_GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-5)}
SSD_DA_TIMES = 4
# the gated norm's backward: K2's backward sweep (zamba2's d_inner 7168 in it) and
# mamba2's training shape
GATED_BWD_SWEEP = NORM_BWD_SWEEP + [(1, 2048, 5120)]
# kernel names of K3's bf16 backward in profiler traces (three launches a call)
K3_BWD_NAMES = ("ssd_scan_bwd_states", "ssd_scan_bwd_grad", "ssd_scan_bwd_bf16_finish")
# K1's f32 (CUDA-core) backward kernels in profiler traces: none on a bf16 path
K1_BWD_F32_NAMES = ("bwd_dq_kernel", "bwd_dkdv_kernel")
# K1's bf16 backward kernels at head dim 256: the dK/dV pass is the split kernel
K1_BWD_256_NAMES = ("bwd_delta_kernel", "bwd_dq_bf16_kernel", "bwd_dkdv_split_bf16_kernel")

# K1's backward at head dim 256: the forward's D=256 sweep, then gemma3-12b's
# training attention (B=1, H=16, K=8, causal, S=2048 = 2W): a global layer (window
# 0) and a local one (1024), at which it is timed
GEMMA_BWD = [(2048, 0), (2048, 1024)]
# training gemma3-12b at full width, cut to one local:global group (6 layers; a
# depth off the period is refused), bf16, one sequence of 2,048 tokens (2W) a step
GEMMA_TRAIN = {"arch": "gemma3-12b", "reduced": False, "seq_len": 2048, "global_batch": 1,
               "microbatches": 1}
GEMMA_TRAIN_LAYERS = 6
GEMMA_TRAIN_PER_STEP = dense_per_step(GEMMA_TRAIN_LAYERS)
# gemma3's f32 train step on the card against the CPU's: its attention shape (16 q /
# 8 kv heads of 256, window 1,024) over one group of 6 layers, with d_model, d_ff and
# the vocabulary narrowed (6 f32 layers at full width are ~67 GB on each side); 1,100
# tokens, past the window and ragged for 64-row tiles
GEMMA_PARITY = {"num_layers": 6, "d_model": 512, "d_ff": 1024, "vocab_size": 8192}
GEMMA_PARITY_SEQ = 1100


def hybrid_per_step(layers: int, every: int) -> dict:
    """K1, K2 and K3 launches in each zamba2 train step of ``layers`` layers with the
    shared block after every ``every``-th, forward and backward alike (rmsnorm: ln1
    of layer 0; add_rmsnorm: every other mamba2 layer's ln1, the shared block's two
    norms, the final norm; K1 once a shared block; no qk-norm)."""
    G = layers // every
    per = {"flash_attention": G, "ssd_scan": layers, "gated_rmsnorm": layers, "rmsnorm": 1,
           "add_rmsnorm": layers - 1 + 2 * G + 1}
    return {**per, **{f"{name}_bwd": n for name, n in per.items()}}


# training zamba2-7b at full width, cut to 15 layers: two groups of 6 mamba2 layers
# with the shared block after each, and the 3-layer tail (81 layers of state are ~94
# GB), bf16, one sequence of 2,048 tokens a step
ZAMBA_TRAIN = {"arch": "zamba2-7b", "reduced": False, "seq_len": 2048, "global_batch": 1,
               "microbatches": 1}
ZAMBA_TRAIN_LAYERS = 15
ZAMBA_TRAIN_PER_STEP = hybrid_per_step(ZAMBA_TRAIN_LAYERS, 6)
# zamba2's f32 train step on the card against the CPU's: its attention shape (32 heads
# of 112) over one group and the tail (9 layers), d_model, d_ff and the vocabulary
# narrowed (d_inner 1024: 16 SSD heads); 600 tokens, past two 256-token chunks and
# ragged for 64-row tiles
ZAMBA_PARITY = {"num_layers": 9, "d_model": 512, "d_ff": 1024, "vocab_size": 8192}
ZAMBA_PARITY_SEQ = 600
# training deepseek-moe-16b at full width, cut to 4 layers (28 layers of state are
# ~218 GB; 4 are ~36.1 GiB), bf16, one sequence of 2,048 tokens a step at the
# config's capacity 1.25 (drops happen); no qk-norm
MOE_TRAIN = {"arch": "deepseek-moe-16b", "reduced": False, "seq_len": 2048,
             "global_batch": 1, "microbatches": 1}
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_PER_STEP = dense_per_step(MOE_TRAIN_LAYERS, qk_norm=False)
# deepseek's f32 train step on the card against the CPU's: its attention (16 heads of
# 128) and expert layout (64 routed, top-6, 2 shared) over the 4 layers it trains at,
# with d_model and the experts' width narrowed 4x and the vocabulary to 8,192; 600
# tokens (ragged for 64-row tiles) at capacity 1.25, so the drop path is differentiated
MOE_PARITY = {"num_layers": MOE_TRAIN_LAYERS, "d_model": 512, "d_ff_expert": 352,
              "vocab_size": 8192}
MOE_PARITY_SEQ = 600


def encdec_per_step(enc: int, dec: int) -> dict:
    """K1 and K2 launches in each whisper train step of ``enc`` encoder and ``dec``
    decoder layers, forward and backward alike (K1: each encoder layer, and each
    decoder layer's self- and cross-attention; rmsnorm: ln1 of each stack's layer 0;
    add_rmsnorm: every other norm, enc_norm and the final norm included; no
    qk-norm)."""
    per = {"flash_attention": enc + 2 * dec, "rmsnorm": 2, "add_rmsnorm": 2 * enc + 3 * dec}
    return {**per, **{f"{name}_bwd": n for name, n in per.items()}}


def vlm_per_step(layers: int) -> dict:
    """K1 and K2 launches in each llama-3.2-vision train step of ``layers`` layers
    (one attention a layer, self or cross; ln1 of layer 0; two norms a layer but
    the first's ln1, and the final norm), forward and backward alike."""
    per = {"flash_attention": layers, "rmsnorm": 1, "add_rmsnorm": 2 * layers}
    return {**per, **{f"{name}_bwd": n for name, n in per.items()}}


# training whisper-medium at full width and depth (24 encoder and 24 decoder layers;
# ~16 GB of state), bf16, 4 x 2,048 tokens a step over 4 x 1,500 frames (the
# Trainer's one fixed draw); its checkpointed task at the same depth (a save is ~14
# GB)
WHISPER_TRAIN = {"arch": "whisper-medium", "reduced": False, "seq_len": 2048,
                 "global_batch": 4, "microbatches": 1}
WHISPER_LAYERS = 24
# whisper's f32 train step on the card against the CPU's: full width, 2 encoder and 2
# decoder layers, 600 tokens (ragged for 64-row tiles) over its 1,500 frames
WHISPER_PARITY = {"num_layers": 2, "encoder_layers": 2}
WHISPER_PARITY_SEQ = 600
# llama-3.2-vision's f32 train step on the card against the CPU's (it trains on the
# card at no depth: one group's state alone is ~100 GB): its attention shape (64 q /
# 8 kv heads of 128) over one group (4 self layers and a gated cross layer onto its
# 1,601 patches), d_model, d_ff and the vocabulary narrowed; 600 tokens
LLAMA_PARITY = {"num_layers": 5, "d_model": 1024, "d_ff": 2048, "vocab_size": 8192}
LLAMA_PARITY_SEQ = 600
# the train phases of one job each (cut in depth but whisper-medium's): job, layers,
# launches a step, and the head dim and names of K1's backward kernels there
CUT_TRAINS = {
    "gemma3-12b train": {"job": GEMMA_TRAIN, "layers": GEMMA_TRAIN_LAYERS,
                         "per_step": GEMMA_TRAIN_PER_STEP, "head_dim": 256,
                         "k1_bwd": K1_BWD_256_NAMES},
    "zamba2-7b train": {"job": ZAMBA_TRAIN, "layers": ZAMBA_TRAIN_LAYERS,
                        "per_step": ZAMBA_TRAIN_PER_STEP, "head_dim": 112,
                        "k1_bwd": K1_BWD_NAMES},
    "deepseek-moe-16b train": {"job": MOE_TRAIN, "layers": MOE_TRAIN_LAYERS,
                               "per_step": MOE_TRAIN_PER_STEP, "head_dim": 128,
                               "k1_bwd": K1_BWD_NAMES},
    "whisper-medium train": {"job": WHISPER_TRAIN, "layers": WHISPER_LAYERS,
                             "per_step": encdec_per_step(WHISPER_LAYERS, WHISPER_LAYERS),
                             "head_dim": 64, "k1_bwd": K1_BWD_NAMES},
}

# local SGD, the Titchener mode: qwen3-0.6b at full width and depth, bf16, 2 pods of
# H = 4 inner steps a round on 2 x 2048 tokens each (32,768 tokens a round), 2 rounds
# through run_train_task; its checkpointed task at 4 layers (a 28-layer save is
# 30.8 GiB of state)
LOCAL_SGD = {"arch": "qwen3-0.6b", "reduced": False, "seq_len": 2048, "global_batch": 4,
             "mode": "local_sgd", "n_pods": 2, "local_sgd": {"inner_steps": 4}, "steps": 8}
LOCAL_SGD_PATH = "qwen3-0.6b local_sgd"
LOCAL_SGD_TASK_LAYERS = 4
# the f32 round on the card against the CPU's: full width, 2 layers, 2 pods, H = 2,
# 1 x 256 tokens a pod and inner step
LOCAL_SGD_PARITY = {"n_pods": 2, "inner_steps": 2, "seq": 256}
# the share of the parity round's int8 delta elements that may round to the next
# int8 value on the card than on the CPU, where the two sides' deltas lie less than
# half a step apart across a rounding boundary (on an H100 80GB HBM3: 200,756 of
# 685,255,680 elements, 2.93e-4)
LOCAL_SGD_FLIP_SHARE = 1e-3
# The cells (``repro_torch.launch.steps.build_cell``) at qwen3-0.6b's full width and
# depth, random weights from seed 0, cut in batch only: train_4k's global batch 256
# to 8 (the cell's M = 8 microbatches of 1 x 4,096 tokens), one step under each remat
# mode from the same state and batch; prefill_32k's 32 to 1 (one 32,768-token
# prompt); decode_32k's 128 (a 481 GB cache) to 4 (15.03 GB), filled from the prefill
# cell's cache, 16 steps teacher-forced over the prompt's last 16 positions; the
# Titchener cell of train_4k (one local-SGD round, H = 8, one pod) at global batch 8
# (Bp = 1). mamba2-2.7b's long_500k cell (B = 1): its fixed-size state from a
# prefill of 32,752 tokens, not of 524,272 (an SSM decode step reads only its state,
# and its position enters no computation), then 16 decode steps at positions
# 524,272-524,287, teacher-forced; the same in f32 at 4 layers against the prefill of
# all 32,768 tokens at LONG_F32_TOL (on an H100 80GB HBM3 the qwen3 decode cell's
# twin measured 3.08e-5 at its 1e-4).
CELLS_ARCH = "qwen3-0.6b"
CELLS_PATH = "qwen3-0.6b cells"
CELLS_TRAIN_BATCH, CELLS_PREFILL_BATCH, CELLS_DECODE_BATCH = 8, 1, 4
CELLS_DECODE_STEPS = 16
CELLS_DECODE_CACHE_BYTES = 15_032_385_536 + 16    # k and v of 28 layers; pos, int32 [4]
LONG_ARCH, LONG_PATH, LONG_PREFILL = "mamba2-2.7b", "mamba2-2.7b long_500k", 32_768
LONG_F32_TOL, LONG_F32_LAYERS = 1e-4, 4
# K1 at Sq = Skv = 32,768: a causal row's output averages v over up to 32,768 keys,
# so late rows are small against TOL's absolute term. Held in f32 (the exact
# design) at TOL and, both dtypes, by ``rms_tol`` at RMS_UNIT_TOL; the plain output
# with the last CELLS_K1_DROP keys' values zeroed (what a kernel that skipped the
# last kv tile's product would give its last rows) must fail the f32 gates.
CELLS_K1_DROP = 64
# the dry-run's predicted peak of the train cell (remat full) against the card's
DRYRUN_PEAK_RTOL = 0.25
TRAIN_100M_PATH = "qwen3 100M example"
TRAIN_100M_STEPS = 300


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, n: int = 20) -> float:
    """Median device time of one call over ``n`` back-to-back calls, after
    warm-up. A sleep kernel holds the card while the host enqueues every call,
    so host launch latency does not show up as device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda._sleep(100_000_000)
    ev[0].record()
    for i in range(n):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(n))


def time_batch_ms(fn, n: int = 50) -> float:
    """Device time of one call from a single event pair around ``n`` back-to-back
    calls: without ``time_ms``'s event after every call, so its per-event floor
    does not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn, n: int = 200) -> float:
    """Host time to enqueue one call (wrapper checks, allocation, launch), with
    the card held by a sleep kernel so the queue never drains or fills."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def wall_ms(fn, n: int = 10) -> float:
    """Median host wall time of one call that ends in a synchronize: what an
    eager caller waits, host launch latency included."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def close(a, b, tol) -> bool:
    a, b = a.float(), b.float()
    return bool(torch.isfinite(a).all()) and bool(
        ((a - b).abs() <= tol + tol * b.abs()).all())


def needed_tol(a, b) -> float:
    """The least tol at which ``close(a, b, tol)`` holds (finite a)."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (1 + b.abs())).max().item()


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the end-aligned mask keeps: the work this input needs."""
    total = 0
    for i in range(Sq):
        qa = i + Skv - Sq
        hi = min(Skv, qa + 1) if causal else Skv
        lo = max(0, qa - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Flops of the chunked SSD scan for these shapes: C.B^T once per chunk
    (G=1) over the causal pairs, then per head the masked score product, the
    carried state's readout and the state update."""
    total = 0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        pairs = q * (q + 1) // 2
        total += 2 * B * (pairs * N + H * (pairs * P + 2 * q * N * P))
    return total


def kernel_wrappers() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SS
    return {"flash_attention": FA.flash_attention_cuda, "rmsnorm": RN.rmsnorm_cuda,
            "add_rmsnorm": RN.add_rmsnorm_cuda, "gated_rmsnorm": RN.gated_rmsnorm_cuda,
            "qk_norm_rope": RN.qk_norm_rope_cuda, "ssd_scan": SS.ssd_scan_cuda,
            "flash_attention_bwd": FA.flash_attention_bwd_cuda,
            "rmsnorm_bwd": RN.rmsnorm_bwd_cuda, "add_rmsnorm_bwd": RN.add_rmsnorm_bwd_cuda,
            "gated_rmsnorm_bwd": RN.gated_rmsnorm_bwd_cuda,
            "qk_norm_rope_bwd": RN.qk_norm_rope_bwd_cuda, "ssd_scan_bwd": SS.ssd_scan_bwd_cuda}


def reset_launches() -> dict:
    """Every kernel wrapper's count set to 0; returns the wrappers by name."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def named_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, path + (k,))
    else:
        yield path, tree


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def flash_bwd_inputs(gen, B, Sq, Skv, H, K, D, dtype):
    """q, k, v, dO of one K1 backward case."""
    return (randn((B, Sq, H, D), dtype, gen), randn((B, Skv, K, D), dtype, gen),
            randn((B, Skv, K, D), dtype, gen), randn((B, Sq, H, D), dtype, gen))


def norm_bwd_case(gen, shape, dtype):
    """x, scale, dy, ds of one K2 norm backward case."""
    return (randn(shape, dtype, gen), randn(shape[-1:], dtype, gen),
            randn(shape, dtype, gen), randn(shape, dtype, gen))


def qk_bwd_case(gen, B, S, H, K, hd, dtype):
    """The arguments of one qk_norm_rope backward case (positions: the model's
    expanded arange)."""
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    return (randn((B, S, H, hd), dtype, gen), randn((B, S, K, hd), dtype, gen),
            randn((hd,), dtype, gen), randn((hd,), dtype, gen), pos, QWEN3_THETA,
            randn((B, S, H, hd), dtype, gen), randn((B, S, K, hd), dtype, gen))


def exact(args):
    """f32 inputs widened to f64: the plain twin then gives the exact value.
    dscale sums up to 131,072 rows, and two f32 sums of them in different
    orders differ by more than 1e-5 near zero, so f32 outputs are held at
    K2's 1e-5 against the exact value, not against another f32 sum."""
    return [a.double() if torch.is_tensor(a) and a.dtype == torch.float32 else a
            for a in args]


# ----------------------------------------------------------------------- phases
def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    return smi.splitlines()[0]


def ptxas_kernels(log: str) -> list:
    """[mangled name, spill store bytes, registers] of each kernel in an nvcc
    -Xptxas -v log, and of each device function compiled on its own (not
    inlined: its registers count in its callers', so 0 here)."""
    kernels, entry, props = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif "spill stores" in line and props:
            stores = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            kernels.append([props, stores, 0])
        elif "Used" in line and "registers" in line and kernels and kernels[-1][0] == entry:
            kernels[-1][2] = int(re.search(r"Used (\d+) registers", line).group(1))
    return kernels


def gated_registers(kernels: list, strict: bool = True) -> list:
    """"name<args> registers" of each kernel that must not spill (K1's forward in
    both designs at every head dim, its bf16 backward ones, every instance of K2's
    two backward kernels and K3's bf16 backward ones), failing on any that spills
    (strict) or naming its spill stores."""
    out = []
    for kernel, stores, r in kernels:
        k1 = re.search(r"(bwd_\w+_bf16_kernel|flash_fwd_bf16_kernel|flash_fwd_kernel)ILi(\d+)E",
                       kernel)
        k2 = re.search(r"(rows_bwd_kernel|qk_norm_rope_bwd_kernel|fold)I(f|13__nv_bfloat16)"
                       r"Li(\d+)E(Li([012])E)?", kernel)
        k3 = re.search(r"(ssd_scan_bwd_states|ssd_scan_bwd_grad)ILi(\d+)ELi(\d+)E"
                       r"|(ssd_scan_bwd_bf16_finish)E", kernel)
        if k1:
            name = f"{k1.group(1)}<{k1.group(2)}>"
        elif k3:
            name = k3.group(4) or f"{k3.group(1)}<N={k3.group(2)}, P={k3.group(3)}>"
        elif k2:
            add = {"0": ", plain", "1": ", add", "2": ", gated"}.get(k2.group(5), "")
            dtype = "f32" if k2.group(2) == "f" else "bf16"
            name = f"{k2.group(1)}<{dtype}, {k2.group(3)}{add}>"
        else:
            continue
        check(stores == 0 or not strict, f"{name} spills {stores} bytes")
        if r or stores:      # a function's registers are its callers'
            out.append(f"{name} {r}" + (f" (spills {stores} bytes)" if stores else ""))
    return out


def phase_build() -> None:
    """Build every source; print each one's kernels, their registers, and every
    kernel that spills, by name (from nvcc's -Xptxas -v log). K1's forward
    kernels, K1's and K3's bf16 backward kernels and every K2 backward kernel
    must not spill."""
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    paths = _build.build(names)
    print(f"build: {names} in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        kernels = ptxas_kernels(log.read_text() if log.exists() else "")
        regs = [k[2] for k in kernels if k[2]] or [0]     # kernels (functions have 0)
        spills = [k for k in kernels if k[1]]
        print(f"  ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
              f"{len(spills)} spilling")
        for kernel, stores, r in spills:
            print(f"    spills {stores} bytes at {r} registers: {kernel}")
        gated = gated_registers(kernels)
        if gated:
            print(f"    gated kernels, registers (no spill stores): {', '.join(gated)}")
        if name == "flash_attention":      # forward, dK/dV pass, dQ pass at each
            for D in (112, 256):
                at_d = [g for g in gated
                        if re.match(rf"(bwd_\w+_bf16_kernel|flash_fwd_bf16_kernel)<{D}> ", g)]
                check(len(at_d) == 3, f"build: K1's three bf16 kernels at head dim {D} are "
                      f"not all in the ptxas log: {at_d}")
                print(f"    K1's bf16 kernels at head dim {D} (no spill): {', '.join(at_d)}")


def phase_flash(gen) -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    def qkv(B, Sq, Skv, H, K, D, dtype):
        return (randn((B, Sq, H, D), dtype, gen), randn((B, Skv, K, D), dtype, gen),
                randn((B, Skv, K, D), dtype, gen))

    # the sweep and the plane serve job's prompts, both dtypes, and short q
    # (end-aligned masks) against the oracle
    for B, S, H, K, D, causal, window in FLASH_SWEEP + PLANE_ATTN + LAUNCH_ATTN:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(B, S, S, H, K, D, dtype)
            got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
            check(close(got, want, TOL[dtype]),
                  f"flash {B, S, H, K, D, causal, window} {dtype}: max err "
                  f"{max_err(got, want)}")
    for B, Sq, Skv, H, K, D, causal, window in SHORT_Q:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(B, Sq, Skv, H, K, D, dtype)
            got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            check(close(got, want, TOL[dtype]),
                  f"flash Sq<Skv {B, Sq, Skv, causal, window} {dtype}: {max_err(got, want)}")
    print(f"flash_attention: sweep, the plane serve job's prompts (S = {PLANE_LENS}), the "
          f"launcher train job's {LAUNCH_ATTN} and Sq<Skv cases match (f32 CUDA-core and "
          f"bf16 tensor-core designs)")

    row = None
    for S in (512, 1024, 2048):          # 512 = the served prompt: the main path
        B, H, K, D, dtype = 1, 16, 8, 128, torch.bfloat16
        q, k, v = qkv(B, S, S, H, K, D, dtype)
        got = FA.flash_attention_cuda(q, k, v)
        want = FA.flash_attention_plain(q, k, v)
        err = max_err(got, want)
        check(close(got, want, TOL[dtype]), f"flash S={S} bf16: max err {err}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        check(close(lib.transpose(1, 2), want, TOL[dtype]), "SDPA disagrees with plain")
        ms = time_ms(lambda: FA.flash_attention_cuda(q, k, v))
        plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * B * H * D * attn_pairs(S, S, True, 0)
        bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[dtype])
        print(f"flash_attention B=1 S={S} H=16 K=8 D=128 bf16 causal: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
              f"{flops / ms / 1e9:.1f} TFLOP/s, max abs err {err:.3g}")
        if S == 512:
            row = {"name": "flash_attention", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention.py:27",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    row["head_dim_256"] = phase_flash_head_dim(
        gen, qkv, 256, FLASH_256_SWEEP, [(1, S, 16, 8, w) for S, w in GEMMA_ATTN])
    row["head_dim_112"] = phase_flash_head_dim(
        gen, qkv, 112, FLASH_112_SWEEP, [(1, S, 32, 32, 0) for S in ZAMBA_ATTN])
    row["gqa_64_4"] = phase_flash_head_dim(gen, qkv, 128, MOE_ATTN_SWEEP, MOE_ATTN)
    row["gqa_24_8"] = phase_flash_head_dim(gen, qkv, 128, PHI4_ATTN_SWEEP, PHI4_ATTN)
    return row


def sdpa_backend(*args, **kw) -> str:
    """The backend SDPA's dispatcher picks for these arguments."""
    from torch.nn.attention import SDPBackend
    names = {b.value: n for n, b in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(*args, **kw)), "unknown")


def sdpa_kw(S: int, window: int) -> dict:
    """SDPA's arguments for causal GQA attention over S tokens: ``is_causal``, or
    with a window a boolean band mask (which takes SDPA off its flash backend)."""
    if not window:
        return {"is_causal": True, "enable_gqa": True}
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    return {"attn_mask": band, "enable_gqa": True}


def phase_flash_head_dim(gen, qkv, D: int, sweep: list, timed: list) -> list:
    """K1's forward at head dim D against its plain version over ``sweep`` in both
    dtypes (f32: the CUDA-core design; bf16: the tensor-core one, at 256 with 32-row
    kv tiles), then at each (B, S, H, K, window) of ``timed`` (causal) in both dtypes
    and timed there in bf16 beside its bound, its plain version and SDPA (with a
    boolean band mask where a window applies, which takes SDPA off its flash
    backend; the backend it ran is printed). Where D is below 128 it is also timed
    as the TPU route runs it (``pad_to_128_ms``). Returns one entry per
    shape of ``timed``."""
    from repro_torch.kernels import flash_attention as FA
    for B, Sq, Skv, H, K, causal, window in sweep:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(B, Sq, Skv, H, K, D, dtype)
            got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
            check(close(got, want, TOL[dtype]),
                  f"flash D={D} {B, Sq, Skv, H, K, causal, window} {dtype}: max err "
                  f"{max_err(got, want)}")
    print(f"flash_attention D={D}: {len(sweep)} sweep cases match in f32 (2e-5) "
          f"and bf16 (2e-2)")
    out = []
    for B, S, H, K, window in timed:
        dtype = torch.bfloat16
        q, k, v = qkv(B, S, S, H, K, D, dtype)
        f32 = [t.float() for t in (q, k, v)]
        got32 = FA.flash_attention_cuda(*f32, window=window)
        want32 = FA.flash_attention_plain(*f32, window=window)
        check(close(got32, want32, TOL[torch.float32]),
              f"flash D={D} S={S} window={window} f32: max err {max_err(got32, want32)}")
        got = FA.flash_attention_cuda(q, k, v, window=window)
        want = FA.flash_attention_plain(q, k, v, window=window)
        err = max_err(got, want)
        check(close(got, want, TOL[dtype]), f"flash D={D} S={S} window={window} bf16: "
              f"max err {err}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_kw = sdpa_kw(S, window)
        backend = sdpa_backend(qt, kt, vt, **lib_kw)
        lib = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
        check(close(lib.transpose(1, 2), want, TOL[dtype]),
              f"SDPA disagrees with plain at D={D} S={S} window={window}")
        ms = time_ms(lambda: FA.flash_attention_cuda(q, k, v, window=window))
        plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v, window=window))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * B * H * D * attn_pairs(S, S, True, window)
        bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[dtype])
        entry = {"B": B, "S": S, "H": H, "K": K, "window": window, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": lib_ms, "library_backend": backend}
        padded = ""
        if D < 128:
            entry.update(pad_to_128(q, k, v, want, window))
            padded = (f"; padded to 128 as the TPU route runs it: kernel "
                      f"{entry['pad_to_128_kernel_ms']:.4f} ms on padded inputs, "
                      f"{entry['pad_to_128_ms']:.4f} ms with the pads and the slice, max abs "
                      f"err {entry['pad_to_128_max_abs_err']:.3g}")
        print(f"flash_attention B={B} S={S} H={H} K={K} D={D} bf16 causal window={window}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
              f"({backend}), bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} TFLOP/s, max abs err "
              f"{err:.3g} (f32 {max_err(got32, want32):.3g}){padded}")
        out.append(entry)
        del f32, got32, want32
    return out


def pad_to_128(q, k, v, want, window: int) -> dict:
    """K1's forward as the TPU route runs a head dim below 128 (src/repro/kernels/
    ops.py:148-171): q, k and v zero-padded to 128 outside the kernel, the D=128
    instance launched through the C entry point with the true dim's scale
    1/sqrt(D), the output sliced back. Held against ``want`` (the plain version
    at the true dim) at the bf16 gate; returns its times."""
    from repro_torch.kernels import flash_attention as FA
    B, S, H, D = q.shape
    K = k.shape[2]
    fn = FA._kernel_fn()
    stream = torch.cuda.current_stream().cuda_stream

    def run(qp, kp, vp):
        out = torch.empty_like(qp)
        err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), B, S, S, H, K,
                 128, 1, int(window), 1.0 / math.sqrt(D), FA._DTYPE_CODE[q.dtype], stream,
                 None)
        check(err == 0, f"flash_attention_fwd at head dim 128 (padded): cudaError {err}")
        return out

    def padded_call():
        qp, kp, vp = (F.pad(t, (0, 128 - D)) for t in (q, k, v))
        return run(qp, kp, vp)[..., :D]

    got = padded_call()
    check(close(got, want, TOL[q.dtype]), f"flash padded to 128 (D={D}, S={S}): max err "
          f"{max_err(got, want)}")
    qp, kp, vp = (F.pad(t, (0, 128 - D)) for t in (q, k, v))
    return {"pad_to_128_kernel_ms": time_ms(lambda: run(qp, kp, vp)),
            "pad_to_128_ms": time_ms(padded_call),
            "pad_to_128_max_abs_err": max_err(got, want)}


def rms_tol(got: torch.Tensor, want: torch.Tensor) -> float:
    """The least tol at which |got - want| <= tol * (rms(want) + |want|) holds:
    ``needed_tol`` with the values' RMS in place of 1 as the unit of the
    absolute term, so that a gate means the same at every scale."""
    w = want.float()
    return ((got.float() - w).abs() / (w.square().mean().sqrt() + w.abs())).max().item()


def phase_flash_encdec(gen) -> tuple:
    """K1 as the encoder-decoder and VLM paths call it: not causal over Sq != Skv
    (CROSS_ATTN_SWEEP, CROSS_ATTN, both ways) and at their self-attention shapes
    (SELF_ATTN). Forward and backward against their plain versions in f32 (the
    CUDA-core designs) and bf16 (the tensor-core ones), each output held at TOL
    (FLASH_GRAD_TOL) and by ``rms_tol`` at RMS_UNIT_TOL, the forward's LSE against
    the plain LSE, two backward runs bit-equal; then each shape of CROSS_ATTN and
    SELF_ATTN timed in bf16 (both ways where it trains) beside its bound, its plain
    version and SDPA (its backend printed). Returns (forward entries, backward
    entries), one a timed shape."""
    from repro_torch.kernels import flash_attention as FA
    f32, bf16 = torch.float32, torch.bfloat16
    cross = [c + (False, True) for c in CROSS_ATTN]
    cases = [c + (False, True) for c in CROSS_ATTN_SWEEP] + cross + SELF_ATTN
    worst = {(dt, way, n): 0.0 for dt in (f32, bf16) for way in ("fwd", "bwd")
             for n in ("abs", "rms")}

    def held(tag: str, got, want, tol: float, dtype, way: str) -> None:
        err, ratio = max_err(got, want), rms_tol(got, want)
        check(close(got, want, tol) and ratio <= RMS_UNIT_TOL[dtype, way],
              f"{tag}: max err {err}, rms_tol {ratio:.3g} (gates {tol} and "
              f"{RMS_UNIT_TOL[dtype, way]})")
        worst[dtype, way, "abs"] = max(worst[dtype, way, "abs"], err)
        worst[dtype, way, "rms"] = max(worst[dtype, way, "rms"], ratio)

    for B, Sq, Skv, H, K, D, causal, both in cases:
        for dtype in (f32, bf16):
            tag = f"flash {B, Sq, Skv, H, K, D} causal={causal} {dtype}"
            q, k, v, do = flash_bwd_inputs(gen, B, Sq, Skv, H, K, D, dtype)
            o, lse = FA.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
            want, plain_lse = FA.flash_attention_plain(q, k, v, causal=causal,
                                                       return_lse=True)
            held(tag, o, want, TOL[dtype], dtype, "fwd")
            check(close(lse, plain_lse, TOL[f32]), f"{tag}: lse max err "
                  f"{max_err(lse, plain_lse)}")
            if both:
                got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
                again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
                want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
                for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
                    held(f"{tag} {name}", g, w, FLASH_GRAD_TOL[dtype], dtype, "bwd")
                    check(torch.equal(g, a), f"{tag} {name}: two runs differ")
                del got, again
            del q, k, v, do, o, lse, want
    print(f"flash_attention at the encoder-decoder and VLM shapes (not causal over Sq != "
          f"Skv, and their self-attention): {len(cases)} cases x f32/bf16 match the plain "
          f"forward and, {sum(c[-1] for c in cases)} of them, backward; largest error, "
          f"absolute / rms_tol: forward f32 {worst[f32, 'fwd', 'abs']:.3g} / "
          f"{worst[f32, 'fwd', 'rms']:.3g}, bf16 {worst[bf16, 'fwd', 'abs']:.3g} / "
          f"{worst[bf16, 'fwd', 'rms']:.3g}; backward f32 {worst[f32, 'bwd', 'abs']:.3g} / "
          f"{worst[f32, 'bwd', 'rms']:.3g}, bf16 {worst[bf16, 'bwd', 'abs']:.3g} / "
          f"{worst[bf16, 'bwd', 'rms']:.3g} (gates: RMS_UNIT_TOL); the LSE matches; two "
          f"backward runs bit-equal")
    fwd, bwd = [], []
    for B, Sq, Skv, H, K, D, causal, both in cross + SELF_ATTN:
        q, k, v, do = flash_bwd_inputs(gen, B, Sq, Skv, H, K, D, bf16)
        o, lse = FA.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        err = max_err(o, want)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_kw = {"is_causal": causal, "enable_gqa": True}
        backend = sdpa_backend(qt, kt, vt, **lib_kw)
        lib = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
        check(close(lib.transpose(1, 2), want, TOL[bf16]),
              f"SDPA disagrees with plain, {B, Sq, Skv, H, K, D} causal={causal}")
        ms = time_ms(lambda: FA.flash_attention_cuda(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v, causal=causal), n=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw))
        pairs = attn_pairs(Sq, Skv, causal, 0)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * B * H * D * pairs
        bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[bf16])
        shape_txt = f"B={B} Sq={Sq} Skv={Skv} H={H} K={K} D={D} bf16 causal={causal}"
        print(f"flash_attention {shape_txt}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms ({backend}), bound {bound_ms:.4f} ms ({bound_by}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} "
              f"TFLOP/s, max abs err {err:.3g}")
        shape = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "K": K, "D": D, "causal": causal}
        fwd.append(dict(shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=lib_ms, library_backend=backend))
        if not both:
            del q, k, v, do, o, lse, want, qt, kt, vt, lib
            continue
        got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
        err = max(max_err(g, w) for g, w in zip(got, want))
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, **lib_kw)
        dot = do.transpose(1, 2)
        lib = torch.autograd.grad(lib_out, (qg, kg, vg), dot, retain_graph=True)
        # SDPA's gate widened past a GQA group of 4, as phase_flash_bwd_head_dim's
        lib_tol = FLASH_GRAD_TOL[bf16] * max(1.0, math.sqrt(H / K / 4))
        lib_err = max(max_err(g.transpose(1, 2), w) for g, w in zip(lib, want))
        check(all(close(g.transpose(1, 2), w, lib_tol) for g, w in zip(lib, want)),
              f"SDPA's backward disagrees with plain, {B, Sq, Skv, H, K, D} causal={causal}: "
              f"max err {lib_err} at tolerance {lib_tol}")
        ms = time_ms(lambda: FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal))
        plain_ms = time_ms(lambda: FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                                causal=causal), n=5)
        lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dot,
                                                     retain_graph=True))
        # as phase_backward counts them: q, o, dO read and dq written; k, v read and
        # dk, dv written; lse read, delta written and read
        nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + 3 * B * H * Sq * 4
        flops = 10 * B * H * D * pairs
        bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[bf16])
        print(f"flash_attention_bwd {shape_txt}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"SDPA backward {lib_ms:.4f} ms ({backend}), bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
              f"{flops / ms / 1e9:.1f} TFLOP/s, max abs err {err:.3g} (SDPA's {lib_err:.3g})")
        bwd.append(dict(shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=lib_ms, library_backend=backend))
        del q, k, v, do, o, lse, got, want, qt, kt, vt, qg, kg, vg, lib_out, lib
    return fwd, bwd


def phase_rmsnorm(gen) -> list:
    """K2's four entry points: each held against its plain version on the serving
    paths' shapes and the test sweep, in f32 and bf16, then timed at the serving
    shapes beside its byte bound. Returns one JSON row per entry point."""
    from repro_torch.kernels import rmsnorm as RN
    f32, bf16 = torch.float32, torch.bfloat16

    def norm_case(shape, dtype):
        return randn(shape, dtype, gen), randn(shape, dtype, gen), randn(shape[-1:], dtype, gen)

    def qk_case(B, S, H, K, hd, dtype):
        if S == 1:       # decode: pos[:, None] of 4 slots at positions past a prompt
            pos = (torch.arange(B, dtype=torch.int32, device="cuda") * 37 + 512)[:, None]
        else:            # prefill: the model's expanded arange, read through its strides
            pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
        return (randn((B, S, H, hd), dtype, gen), randn((B, S, K, hd), dtype, gen),
                randn((hd,), dtype, gen), randn((hd,), dtype, gen), pos, QWEN3_THETA)

    # entry point -> (kernel, plain, inputs for a case, sweep cases, serving cases
    # (main first), bytes moved, f32 flops, library call or None)
    entries = {
        "rmsnorm": (
            lambda x, r, sc: RN.rmsnorm_cuda(x, sc), lambda x, r, sc: RN.rmsnorm_plain(x, sc),
            norm_case, RMS_SWEEP + PLANE_NORM + LAUNCH_NORM + PHI4_NORM,
            [(1, 512, 1024), (1, 512, 2560), (1, 512, 16, 128), (4, 1, 1024), (4, 1, 2560),
             (1, 512, 3840), (4, 1, 3840), (1, 512, 3584), (4, 1, 3584), *MOE_NORM,
             *CROSS_NORM],
            lambda x, r, sc: (2 * x.numel() + sc.numel()) * x.element_size(),
            lambda x, r, sc: 4 * x.numel(),
            lambda x, r, sc: F.rms_norm(x, sc.shape, weight=sc, eps=1e-6)),
        "add_rmsnorm": (
            RN.add_rmsnorm_cuda, RN.add_rmsnorm_plain, norm_case,
            RMS_SWEEP + PLANE_NORM + LAUNCH_NORM + PHI4_NORM,
            [(1, 512, 1024), (1, 512, 2560), (4, 1, 1024), (4, 1, 2560), (1, 512, 3840),
             (4, 1, 3840), (1, 512, 3584), (4, 1, 3584), *MOE_NORM, *CROSS_NORM],
            lambda x, r, sc: (4 * x.numel() + sc.numel()) * x.element_size(),
            lambda x, r, sc: 5 * x.numel(), None),
        "gated_rmsnorm": (
            RN.gated_rmsnorm_cuda, RN.gated_rmsnorm_plain, norm_case, RMS_SWEEP,
            [(1, 512, 5120), (4, 1, 5120), (1, 512, 7168), (4, 1, 7168)],
            lambda y, z, sc: (3 * y.numel() + sc.numel()) * y.element_size(),
            lambda y, z, sc: 9 * y.numel(), None),
        "qk_norm_rope": (
            RN.qk_norm_rope_cuda, RN.qk_norm_rope_plain, qk_case,
            [(2, 12, 4, 2, 64), (3, 5, 2, 1, 128), (1, 7, 4, 2, 256), *PLANE_QK, *LAUNCH_QK],
            [(1, 512, 16, 8, 128), (4, 1, 16, 8, 128), (1, 512, 16, 8, 256),
             (4, 1, 16, 8, 256), (1, 512, 64, 4, 128), (4, 1, 64, 4, 128)],
            lambda q, k, qs, ks, pos, th: ((2 * (q.numel() + k.numel()) + 2 * qs.numel())
                                           * q.element_size() + pos.numel() * 4
                                           + qs.numel() // 2 * 4),
            lambda q, k, qs, ks, pos, th: 8 * (q.numel() + k.numel()), None),
    }
    rows = []
    for name, (kernel, plain, make, sweep, serving, nbytes, flops, lib) in entries.items():
        worst = 0.0
        for shape in sweep + serving:
            for dtype in (f32, bf16):
                args = make(*shape, dtype) if name == "qk_norm_rope" else make(shape, dtype)
                got, want = kernel(*args), plain(*args)
                got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                for g, w in zip(got, want):
                    err = max_err(g, w)
                    check(close(g, w, RMS_TOL[dtype]), f"{name} {shape} {dtype}: max err {err}")
                    if shape == serving[0] and dtype == bf16:
                        worst = max(worst, err)
        print(f"{name}: matches its plain version on {len(sweep + serving)} shapes in f32 "
              f"and bf16")
        for i, shape in enumerate(serving):
            args = make(*shape, bf16) if name == "qk_norm_rope" else make(shape, bf16)
            ms = time_ms(lambda: kernel(*args))
            in_batch = time_batch_ms(lambda: kernel(*args))
            enqueue_us = host_us(lambda: kernel(*args))
            plain_ms = time_ms(lambda: plain(*args))
            lib_ms = time_ms(lambda: lib(*args)) if lib else None
            bound_ms, bound_by = bound(nbytes(*args), flops(*args), PEAK_FLOPS[f32])
            lib_txt = f"F.rms_norm {lib_ms:.4f} ms" if lib else "library none"
            print(f"{name} {shape} bf16: kernel {ms:.4f} ms ({in_batch:.4f} ms a launch in "
                  f"50 back to back under one event pair), plain {plain_ms:.4f} ms, "
                  f"{lib_txt}, bound {bound_ms:.5f} ms ({bound_by}, "
                  f"{nbytes(*args) / 1e6:.3f} MB); host {enqueue_us:.1f} us to enqueue a call")
            if i == 0:
                rows.append({"name": name, "route": "cuda",
                             "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                             "replaces": "src/repro/kernels/rmsnorm.py:11",
                             "max_abs_err": worst, "ms": ms, "ms_in_batch": in_batch,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": lib_ms})
    floor = time_ms(lambda: None)
    print(f"time_ms floor: {floor:.4f} ms between two events with no launch between them")
    return rows


def phase_ssd(gen) -> dict:
    from repro_torch.kernels import ssd_scan as SS

    def inputs(B, S, H, P, N, dtype):
        return (randn((B, S, H, P), dtype, gen),
                F.softplus(randn((B, S, H), torch.float32, gen)),
                -torch.exp(0.2 * randn((H,), torch.float32, gen)),
                randn((B, S, N), dtype, gen), randn((B, S, N), dtype, gen))

    def held(tag, got, want, tol):
        for name, g, w in zip(("y", "state"), got, want):
            check(close(g, w, tol), f"ssd_scan {tag} {name}: max err {max_err(g, w)}")

    # the sweep (ragged S included) in both dtypes, with and without an initial state
    for B, S, H, P, N, chunk in SSD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            args = inputs(B, S, H, P, N, dtype)
            for h0 in (None, randn((B, H, N, P), torch.float32, gen)):
                held(f"{B, S, H, P, N, chunk} {dtype} init={h0 is not None}",
                     SS.ssd_scan_cuda(*args, chunk=chunk, init_state=h0),
                     SS.ssd_scan_plain(*args, chunk=chunk, init_state=h0), SSD_TOL[dtype])
    # split scan: S1 tokens, then the rest from the first final state == one scan
    args = inputs(2, 256, 4, 64, 32, torch.float32)
    y, h = SS.ssd_scan_cuda(*args, chunk=64)
    y1, h1 = SS.ssd_scan_cuda(*(t[:, :100].contiguous() if t.dim() > 1 else t
                                for t in args), chunk=64)
    y2, h2 = SS.ssd_scan_cuda(*(t[:, 100:].contiguous() if t.dim() > 1 else t
                                for t in args), chunk=64, init_state=h1)
    held("split 100+156", (torch.cat([y1, y2], dim=1), h2), (y, h), 2e-4)
    print("ssd_scan: sweep (f32, bf16, ragged S, init_state) and split scan match")

    # zamba2-7b's prefill: H=112, N=64. f32 against the plain version in f64: over
    # a 256-row chunk the plain f32 cumsum of dt * A reaches ~-200, where an f32
    # ulp is 1.5e-5, which alone can cost the plain f32 version most of the gate
    # (the kernel's cumsum restarts every 64 rows)
    zamba = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = inputs(*SSD_ZAMBA[:5], dtype)
        got = SS.ssd_scan_cuda(*args, chunk=SSD_ZAMBA[5])
        want = SS.ssd_scan_plain(*(f64(args) if dtype == torch.float32 else args),
                                 chunk=SSD_ZAMBA[5])
        held(f"{SSD_ZAMBA} {dtype}", got, want, SSD_TOL[dtype])
    zamba["max_abs_err"] = max(max_err(g, w) for g, w in zip(got, want))
    zamba["ms"] = time_ms(lambda: SS.ssd_scan_cuda(*args, chunk=SSD_ZAMBA[5]))
    zamba["plain_ms"] = time_ms(lambda: SS.ssd_scan_plain(*args, chunk=SSD_ZAMBA[5]))
    B, S, H, P, N, chunk = SSD_ZAMBA
    nbytes = (2 * args[0].numel() + args[3].numel() + args[4].numel()) * 2 \
        + (args[1].numel() + args[2].numel() + B * H * N * P) * 4
    zamba["bound_ms"], zamba["bound_by"] = bound(nbytes, ssd_flops(*SSD_ZAMBA), PEAK_FLOPS[dtype])
    print(f"ssd_scan B={B} S={S} H={H} P={P} N={N} chunk={chunk} bf16 (zamba2-7b): kernel "
          f"{zamba['ms']:.4f} ms, plain {zamba['plain_ms']:.4f} ms, library none, bound "
          f"{zamba['bound_ms']:.5f} ms ({zamba['bound_by']}; {nbytes / 1e6:.2f} MB), max abs "
          f"err {zamba['max_abs_err']:.3g}; f32 and bf16 within the gates")

    B, S, H, P, N, chunk = SSD_MAIN
    dtype = torch.bfloat16
    args = inputs(B, S, H, P, N, dtype)
    got = SS.ssd_scan_cuda(*args, chunk=chunk)
    want = SS.ssd_scan_plain(*args, chunk=chunk)
    held(f"{SSD_MAIN} bf16", got, want, SSD_TOL[dtype])
    err = max(max_err(g, w) for g, w in zip(got, want))
    # as the model passes them: x, B, C read in place from one conv output
    conv = torch.cat([args[0].reshape(B, S, H * P), args[3], args[4]], dim=-1)
    views = (conv[..., :H * P].reshape(B, S, H, P), args[1], args[2],
             conv[..., H * P:H * P + N], conv[..., H * P + N:])
    on_views = SS.ssd_scan_cuda(*views, chunk=chunk)
    for name, g, w in zip(("y", "state"), on_views, got):
        check(torch.equal(g, w), f"ssd_scan on conv-output views: {name} differs from "
              f"contiguous inputs by {max_err(g, w)}")
    views_ms = time_ms(lambda: SS.ssd_scan_cuda(*views, chunk=chunk))
    ms = time_ms(lambda: SS.ssd_scan_cuda(*args, chunk=chunk))
    plain_ms = time_ms(lambda: SS.ssd_scan_plain(*args, chunk=chunk))
    # x and y in bf16; B, C in bf16; dt, A and the final state in f32
    nbytes = (2 * args[0].numel() + args[3].numel() + args[4].numel()) * 2 \
        + (args[1].numel() + args[2].numel() + B * H * N * P) * 4
    flops = ssd_flops(B, S, H, P, N, chunk)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[dtype])
    print(f"ssd_scan B={B} S={S} H={H} P={P} N={N} chunk={chunk} bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library none, bound {bound_ms:.5f} ms ({bound_by}; "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.2f} TFLOP/s, "
          f"max abs err {err:.3g} (|y| max {want[0].float().abs().max().item():.3g}); "
          f"on the conv output's strided views {views_ms:.4f} ms, bit-equal")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:27",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "zamba2": zamba}


def aux_inputs(cfg, B: int, gen) -> dict:
    """Random frames (encdec) or patches (vlm) [B, M, d_model] in the config's
    dtype from ``gen``, as a check against forward draws them (the servers feed
    zeros); {} for the other families."""
    if cfg.family not in ("encdec", "vlm"):
        return {}
    name, M = (("frames", cfg.encoder_frames) if cfg.family == "encdec"
               else ("patches", cfg.num_patches))
    return {name: randn((B, M, cfg.d_model), getattr(torch, cfg.dtype), gen)}


def with_gates(params: dict, gate: float = CROSS_GATE) -> dict:
    """params with every vlm cross layer's gate at ``gate`` (a new tree; other
    families' params as they are)."""
    if "cross_layers" not in params:
        return params
    cross = params["cross_layers"]
    return dict(params, cross_layers=dict(cross, gate=torch.full_like(cross["gate"], gate)))


def decode_vs_forward(model, params, toks, gen) -> dict:
    """{stage: (logits, forward's logits at the same position)} for prefill of
    toks[:, :-1] and one decode step of toks[:, -1]; an encdec or vlm model reads
    random frames or patches from ``gen`` in all three calls."""
    k = toks.shape[1] - 1
    aux = aux_inputs(model.cfg, toks.shape[0], gen)
    with torch.inference_mode():
        full, _ = model.forward(params, {"tokens": toks, **aux})
        last, kv = model.prefill(params, {"tokens": toks[:, :k], **aux}, max_len=2 * k)
        step, _ = model.decode_step(params, toks[:, k:], kv)
    return {"prefill": (last, full[:, k - 1]), "decode": (step, full[:, k])}


def no_drop_capacity(cfg) -> float:
    """The smallest whole capacity factor at which a group's capacity C =
    int(S * K * factor / E) reaches its S tokens: every expert can take every
    token of its row, so the dispatch drops no assignment, whatever the routing."""
    return float(math.ceil(cfg.num_experts / cfg.top_k))


def routing_drops(routes: list, cfg, S: int) -> str:
    """From the router calls over S tokens in ``routes`` (forward's, one a layer):
    the largest share of a row's tokens that one expert took, and the assignments
    that the dispatch would drop at each of MOE_CAPACITIES, summed over layers."""
    from repro_torch.models import moe as MOE
    E = cfg.num_experts
    most, drops = 0.0, dict.fromkeys(MOE_CAPACITIES, 0)
    for idx, _ in routes:
        if idx.shape[1] != S:
            continue
        B = idx.shape[0]
        counts = torch.zeros((B, E), dtype=torch.int64, device=idx.device).scatter_add_(
            1, idx.reshape(B, -1), torch.ones_like(idx.reshape(B, -1)))
        most = max(most, counts.max().item() / S)
        for factor in MOE_CAPACITIES:
            C = MOE.capacity(dataclasses.replace(cfg, capacity_factor=factor), S)
            drops[factor] += (counts - C).clamp_min(0).sum().item()
    return (f"one expert took up to {most:.3f} of a row's tokens; assignments past "
            f"capacity, summed over layers: " + ", ".join(
                f"{n} at factor {f}" for f, n in drops.items()))


def forward_checks(arch: str, model, params: dict, path: dict) -> list:
    """Prefill + one decode step against ``forward`` at full width on the served
    params, at ``path``'s depths and tolerances; returns the token batches drawn."""
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map

    # prefill + one decode step == forward's logits, at full width. In f32 the
    # two paths agree to ~2e-5 at every layer. In bf16 their rounding drifts
    # apart with depth (qwen3: max ~0.03 at 4 layers, ~0.15 at 28 on random
    # weights), so the JAX suite's bf16 tolerance 0.08, set on 4-layer reduced
    # configs (6 for gemma3: one local:global group), is held at that depth; the
    # full-depth bf16 decode error is printed.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    L = model.cfg.num_layers
    f32_layers, bf16_layers = (n or L for n in path["check_layers"])
    # the MoE paths' checks at a capacity where the dispatch drops nothing
    moe = model.cfg.family == "moe"
    check_cfg = dataclasses.replace(model.cfg, capacity_factor=no_drop_capacity(
        model.cfg)) if moe else model.cfg
    at_cap = f", capacity {check_cfg.capacity_factor}" if moe else ""

    def cut(n):
        """The first n layers (vlm: n // cross_attn_every whole groups), every vlm
        gate at CROSS_GATE."""
        if model.cfg.family == "vlm":
            g = n // model.cfg.cross_attn_every
            return lambda: with_gates(dict(params, **{
                part: tree_map(lambda t: t[:g], params[part])
                for part in ("self_layers", "cross_layers")}))
        return lambda: dict(params, layers=tree_map(lambda t: t[:n], params["layers"]))

    cases = [
        (f"f32, {f32_layers} layers{at_cap}",
         dataclasses.replace(check_cfg, dtype="float32", num_layers=f32_layers),
         lambda: tree_map(lambda t: t.float(), cut(f32_layers)()),
         {"prefill": 1e-4, "decode": 1e-4}),
        (f"bf16, {bf16_layers} layers{at_cap}",
         dataclasses.replace(check_cfg, num_layers=bf16_layers),
         cut(bf16_layers), {"prefill": 0.08, "decode": 0.08})]
    if bf16_layers < L:
        cases.append((f"bf16, {L} layers{at_cap}", check_cfg, cut(L),
                      {"prefill": path["deep_prefill_tol"], "decode": None}))
    all_toks = [torch.randint(0, model.cfg.vocab_size, shape, generator=gen, device="cuda")
                for shape in path["toks"]]
    for tag, cfg, make_params, tols in cases:
        case_params = make_params()
        for toks in all_toks:
            with router_log([]) as routes:
                compared = decode_vs_forward(Model(cfg, "cuda"), case_params, toks, gen)
            if moe:
                print(f"{arch} routing of forward ({tag}, toks {tuple(toks.shape)}): "
                      f"{routing_drops(routes, cfg, toks.shape[1])}")
            for name, (got, want) in compared.items():
                err = max_err(got, want)
                print(f"{arch} {name} vs forward logits (full width, {tag}, toks "
                      f"{tuple(toks.shape)}): max abs err {err:.4g}, |logit| max "
                      f"{want.float().abs().max().item():.3g}")
                check(bool(torch.isfinite(got).all()), f"{arch} {name} ({tag}): non-finite "
                      f"logits")
                if tols[name] is not None:
                    check(close(got, want, tols[name]), f"{arch} {name} vs forward ({tag}, "
                          f"toks {tuple(toks.shape)}): max err {err} > tolerance {tols[name]}")
            gc.collect()
        del case_params
        gc.collect()
        torch.cuda.empty_cache()
    return all_toks


def phase_serve(card: str, path: dict) -> dict:
    """Serve one model at full width; returns each kernel's launches in the task."""
    from repro_torch.runtime.serve_loop import ServeJobConfig
    from repro_torch.runtime.step_cache import ServerCache, run_serve_task

    arch = path["arch"]
    payload = dict(SERVE, arch=arch)
    cache = ServerCache(1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    wrappers = reset_launches()
    t0 = time.perf_counter()
    res = run_serve_task(cache, payload)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"serve {arch}: {res} in {wall:.2f} s (incl. param init); launches {launches}")
    n, new = payload["n_requests"], payload["max_new"]
    check(res["requests"] == n and res["generated_tokens"] == n * new,
          f"{arch}: expected {n} requests of {new} tokens, got {res}")
    for name, got in launches.items():      # n prefills and the decode steps
        pre, dec = path["launches"].get(name, (0, 0))
        want = pre * n + dec * res["decode_steps"]
        check(got == want, f"{arch}: {name} launched {got} times in the serve task, want "
              f"{want} ({pre} a prefill, {dec} a decode step)")

    srv = cache.get(ServeJobConfig.from_job({"payload": payload}))  # warm hit
    model, params = srv.model, srv.params
    leaves = list(named_leaves(params))
    n_params = sum(t.numel() for _, t in leaves)
    check(n_params == path["params"] == model.cfg.param_count(), f"{arch}: params {n_params}")
    for name, t in leaves:
        want = torch.float32 if name[-1] in path["f32_leaves"] else torch.bfloat16
        check(t.is_cuda and t.dtype == want, f"{arch}: param {name} is {t.dtype} on "
              f"{t.device}, want {want} on the card")

    all_toks = forward_checks(arch, model, params, path)

    # throughput: one 512-token prefill (with the server's frames or patches);
    # decode steps of all 4 slots
    toks = all_toks[0]
    prompt = {"tokens": toks.new_tensor([list(range(payload["prompt_len"]))]),
              **srv._aux_inputs(1)}
    slots, max_len = payload["slots"], payload["max_len"]
    with torch.inference_mode():
        t_pre = wall_ms(lambda: model.prefill(params, prompt, max_len=max_len))
        dcache = model.init_cache(slots, max_len)
        dcache["pos"].fill_(payload["prompt_len"])
        slot_toks = toks[:, :2].reshape(-1, 1)
        t_dec = wall_ms(lambda: model.decode_step(params, slot_toks, dcache))
        counted = {
            "prefill": profile_breakdown(
                f"{arch} prefill 512 tokens",
                lambda: model.prefill(params, prompt, max_len=max_len)),
            "decode": profile_breakdown(f"{arch} decode step, 4 slots",
                                        lambda: model.decode_step(params, slot_toks, dcache))}
        del dcache
    print(f"{arch} prefill 512 tokens: {t_pre:.2f} ms = "
          f"{payload['prompt_len'] / t_pre * 1e3:.0f} tokens/s [{card}]")
    print(f"{arch} decode step, 4 slots, cache {max_len}: {t_dec:.2f} ms = "
          f"{slots / t_dec * 1e3:.0f} tokens/s [{card}]")
    if path.get("long_prompt"):
        counted["prefill long"] = serve_long_prompt(card, srv, path["long_prompt"],
                                                    payload["max_new"] + 1)
    for call, want in path["kernels"].items():
        n = counted[call]["all kernels"][1]
        check(n == want, f"{arch} {call}: {n} kernels a call, want {want}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run_serve_task(cache, payload)          # same server, rebound
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(warm == res, f"{arch}: warm serve task {warm} != cold {res}")
    print(f"{arch} serve task: cold {wall:.2f} s (incl. param init), warm {warm_s:.2f} s = "
          f"{res['generated_tokens'] / warm_s:.1f} generated tokens/s end to end [{card}]; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def serve_long_prompt(card: str, srv, prompt_len: int, max_new: int) -> dict:
    """One request of ``prompt_len`` tokens through a one-slot ``Server`` that shares
    ``srv``'s params, with ``max_new`` new tokens (the first from the prefill, the
    rest one decode step each); then a profile of that prompt's prefill. Returns
    the profile's groups."""
    from repro_torch.runtime.serve_loop import Server
    long_srv = Server(dataclasses.replace(srv.cfg, slots=1,
                                          max_len=2 * (prompt_len + max_new)),
                      params=srv.params)
    arch = srv.cfg.arch
    prompt = [(7 * j) % srv.arch_cfg.vocab_size for j in range(prompt_len)]
    wrappers = reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = long_srv.submit(prompt, max_new=max_new)
    done = long_srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
    got = long_srv.requests[rid].generated
    print(f"serve {arch} long prompt: {prompt_len} tokens + {len(got)} new in {wall:.2f} s "
          f"({long_srv.steps} decode steps); launches {launches}; tokens {got} [{card}]")
    check(len(done) == 1 and len(got) == max_new and long_srv.steps == max_new - 1,
          f"{arch} long prompt: {len(got)} tokens in {long_srv.steps} decode steps")
    layers = srv.arch_cfg.num_layers
    check(launches.get("flash_attention") == layers, f"{arch} long prompt: K1 launched "
          f"{launches.get('flash_attention')} times, want {layers} (one prefill)")
    check(all(0 <= t < srv.arch_cfg.vocab_size for t in got), f"{arch} long prompt: "
          f"tokens out of range {got}")
    toks = torch.tensor([prompt], device="cuda")
    with torch.inference_mode():
        t_pre = wall_ms(lambda: long_srv.model.prefill(long_srv.params, {"tokens": toks},
                                                       max_len=long_srv.cfg.max_len), n=5)
        prof = profile_breakdown(f"{arch} prefill {prompt_len} tokens",
                                 lambda: long_srv.model.prefill(
                                     long_srv.params, {"tokens": toks},
                                     max_len=long_srv.cfg.max_len))
    print(f"{arch} prefill {prompt_len} tokens: {t_pre:.2f} ms = "
          f"{prompt_len / t_pre * 1e3:.0f} tokens/s [{card}]")
    del long_srv
    gc.collect()
    torch.cuda.empty_cache()
    return prof


def profile_breakdown(tag: str, fn, top: int = 6, groups=None, every: bool = False) -> dict:
    """Device-busy share of one call and its kernels by device time, from
    torch.profiler (the wall time here includes the profiler's own cost), and
    the device time and launches of each group of kernel names (default: K2's
    forward kernels); ``every``: also each kernel name's launches, by name.
    Returns {group: (ms, launches)}, with every kernel of the call under "all
    kernels", {kernel name: launches} under "by name" and the profiled call's
    wall ms under "wall ms"."""
    groups = groups or {"K2": K2_KERNEL_NAMES}
    from torch.profiler import ProfilerActivity, profile
    # The profiler's device timestamps, put on the host's clock, can be off by
    # milliseconds either way, and on some hosts the first kernels of a window
    # go missing (one to three after a pause on most hosts, sixteen and more on
    # one; with no pause, whole calls did). So
    # the window opens and closes on a pause and leads with SPINS sentinel
    # kernels, which take that loss and are not counted. A trace that kept none
    # of them may have lost the call's own first kernels: it is taken again.
    for _ in range(PROFILE_TRIES):
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAUSE_S)
            for _ in range(SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAUSE_S)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = sum(e.count for e in kernels if SPIN_KERNEL in e.key)
        kernels = [e for e in kernels if SPIN_KERNEL not in e.key]
        if spins != SPINS:
            print(f"profile {tag}: {spins} of {SPINS} sentinel kernels in the trace")
        if spins:
            break
    check(spins > 0, f"profile {tag}: {PROFILE_TRIES} traces lost every sentinel kernel")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {tag}: device busy {busy:.2f} ms of {wall:.2f} ms wall "
          f"(idle share {1 - busy / wall:.3f}), {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5} {e.key[:90]}")
    if every:
        print(f"  every kernel by name ({len(kernels)} names):")
        for e in sorted(kernels, key=lambda e: e.key):
            print(f"    x{e.count:<5} {e.self_device_time_total / 1e3:8.3f} ms  {e.key[:100]}")
    out = {"all kernels": (busy, sum(e.count for e in kernels)),
           "by name": {e.key: e.count for e in kernels}, "wall ms": wall}
    for label, names in groups.items():
        mine = [e for e in kernels if any(n in e.key for n in names)]
        n = sum(e.count for e in mine)
        if not n:
            continue
        t = sum(e.self_device_time_total for e in mine)
        out[label] = (t / 1e3, n)
        print(f"  {label}: {t / 1e3:.3f} ms for {n} launches = {t / n:.2f} us a launch")
        for e in mine:
            print(f"    {e.self_device_time_total / e.count:8.2f} us x{e.count:<5} {e.key[:110]}")
    return out


def phase_backward(gen) -> list:
    """K1's backward and K2's three backward entry points against their plain
    versions on the card, in f32 and bf16, each run twice for bit-equality; the
    forward's LSE against the plain LSE; then times at the training shapes.
    Returns one JSON row per backward kernel."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    f32, bf16 = torch.float32, torch.bfloat16

    worst = {f32: 0.0, bf16: 0.0}
    for B, Sq, Skv, H, K, D, causal, window in FLASH_BWD_SWEEP:
        for dtype in (f32, bf16):
            tag = f"flash bwd {B, Sq, Skv, H, K, D, causal, window} {dtype}"
            q, k, v, do = flash_bwd_inputs(gen, B, Sq, Skv, H, K, D, dtype)
            o, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             return_lse=True)
            _, plain_lse = FA.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                    return_lse=True)
            check(close(lse, plain_lse, TOL[f32]), f"{tag}: lse max err "
                  f"{max_err(lse, plain_lse)}")
            got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window)
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                window=window)
            again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                                window=window)
            for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
                check(close(g, w, FLASH_GRAD_TOL[dtype]), f"{tag} {name}: max err "
                      f"{max_err(g, w)}")
                check(torch.equal(g, a), f"{tag} {name}: two runs differ")
                worst[dtype] = max(worst[dtype], max_err(g, w))
    print(f"flash_attention_bwd: {len(FLASH_BWD_SWEEP)} cases x f32/bf16 match the plain "
          f"backward (max abs err f32 {worst[f32]:.3g} at tol {FLASH_GRAD_TOL[f32]}, bf16 "
          f"{worst[bf16]:.3g} at tol {FLASH_GRAD_TOL[bf16]}); the forward's LSE matches; two "
          "runs bit-equal")

    rows = []
    for B, S in FLASH_BWD_TIMED:
        H, K, D = 16, 8, 128
        q, k, v, do = flash_bwd_inputs(gen, B, S, S, H, K, D, bf16)
        o, lse = FA.flash_attention_cuda(q, k, v, return_lse=True)
        got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
        err = max(max_err(g, w) for g, w in zip(got, want))
        check(all(close(g, w, FLASH_GRAD_TOL[bf16]) for g, w in zip(got, want)),
              f"flash bwd B={B} S={S} bf16: max err {err}")
        ms = time_ms(lambda: FA.flash_attention_bwd_cuda(q, k, v, o, lse, do))
        plain_ms = time_ms(lambda: FA.flash_attention_bwd_plain(q, k, v, o, lse, do), n=5)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        lib = torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)
        check(all(close(g.transpose(1, 2), w, FLASH_GRAD_TOL[bf16])
                  for g, w in zip(lib, want)), "SDPA's backward disagrees with plain")
        lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                     retain_graph=True))
        # q, o, dO read and dq written [B,S,H,D]; k, v read and dk, dv written
        # [B,S,K,D]; lse read and delta written and read, f32 [B,H,S]
        nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + 3 * B * H * S * 4
        flops = 10 * B * H * D * attn_pairs(S, S, True, 0)      # 2.5x the forward's
        bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[bf16])
        print(f"flash_attention_bwd B={B} S={S} H=16 K=8 D=128 bf16 causal: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
              f"{flops / ms / 1e9:.1f} TFLOP/s, max abs err {err:.3g}")
        if (B, S) == (1, 2048):
            rows.append({"name": "flash_attention_bwd", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                         "replaces": "src/repro/kernels/ops.py:90",
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        elif B == 4:      # the training shape, beside the B=1 row
            rows[-1]["at_training_shape"] = {
                "B": B, "S": S, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    rows[0]["head_dim_256"] = phase_flash_bwd_head_dim(
        gen, 256, FLASH_256_SWEEP, [(1, S, 16, 8, w) for S, w in GEMMA_BWD])
    rows[0]["head_dim_112"] = phase_flash_bwd_head_dim(
        gen, 112, FLASH_112_SWEEP, [(1, ZAMBA_ATTN[-1], 32, 32, 0)])
    rows[0]["gqa_64_4"] = phase_flash_bwd_head_dim(gen, 128, MOE_ATTN_SWEEP, MOE_ATTN[-1:])
    rows[0]["gqa_24_8"] = phase_flash_bwd_head_dim(gen, 128, PHI4_ATTN_SWEEP, PHI4_ATTN)

    def norm_case(shape, dtype):
        return norm_bwd_case(gen, shape, dtype)

    def qk_case(B, S, H, K, hd, dtype):
        return qk_bwd_case(gen, B, S, H, K, hd, dtype)

    # entry -> (kernel, plain, make inputs, sweep, main shape, bytes, f32 flops, library)
    entries = {
        "rmsnorm_bwd": (
            lambda x, sc, dy, ds: RN.rmsnorm_bwd_cuda(x, sc, dy),
            lambda x, sc, dy, ds: RN.rmsnorm_bwd_plain(x, sc, dy), norm_case,
            NORM_BWD_SWEEP, (4, 2048, 1024),
            lambda x, sc, dy, ds: (3 * x.numel() + 2 * sc.numel()) * x.element_size(),
            lambda x, sc, dy, ds: 12 * x.numel(), "rms_norm"),
        "add_rmsnorm_bwd": (
            lambda x, sc, dy, ds: RN.add_rmsnorm_bwd_cuda(x, sc, ds, dy),
            lambda x, sc, dy, ds: RN.add_rmsnorm_bwd_plain(x, sc, ds, dy), norm_case,
            NORM_BWD_SWEEP, (4, 2048, 1024),
            lambda x, sc, dy, ds: (4 * x.numel() + 2 * sc.numel()) * x.element_size(),
            lambda x, sc, dy, ds: 13 * x.numel(), None),
        "qk_norm_rope_bwd": (
            RN.qk_norm_rope_bwd_cuda, RN.qk_norm_rope_bwd_plain, qk_case, QK_BWD_SWEEP,
            (4, 2048, 16, 8, 128),
            lambda q, k, qs, ks, pos, th, dq, dk: (3 * (q.numel() + k.numel())
                                                   + 4 * qs.numel()) * q.element_size()
            + pos.numel() * 4 + qs.numel() // 2 * 4,
            lambda q, k, qs, ks, pos, th, dq, dk: 16 * (q.numel() + k.numel()), None),
    }
    for name, (kernel, plain, make, sweep, main_shape, nbytes, flops, lib) in entries.items():
        worst = 0.0
        errs = {}     # (shape, dtype) -> max err over the outputs
        for shape in sweep:
            for dtype in (f32, bf16):
                args = make(*shape, dtype) if name == "qk_norm_rope_bwd" else make(shape, dtype)
                got, again = kernel(*args), kernel(*args)
                want = plain(*(exact(args) if dtype == f32 else args))
                for i, (g, w, a) in enumerate(zip(got, want, again)):
                    err = max_err(g, w)
                    check(close(g, w, RMS_TOL[dtype]), f"{name} {shape} {dtype} output {i}: "
                          f"max err {err}")
                    check(torch.equal(g, a), f"{name} {shape} {dtype} output {i}: two runs "
                          "differ")
                    errs[shape, dtype] = max(errs.get((shape, dtype), 0.0), err)
                    if shape == main_shape and dtype == bf16:
                        worst = max(worst, err)
        print(f"{name}: matches its plain version on {len(sweep)} shapes (f32 against its "
              f"f64 evaluation, bf16; dscale included), two runs bit-equal; max err "
              + ", ".join(f"{shape} {str(dtype)[6:]} {err:.3e}"
                          for (shape, dtype), err in errs.items()
                          if shape in (main_shape, GEMMA_NORM_BWD, GEMMA_QK_BWD, ZAMBA_NORM_BWD)))
        args = make(*main_shape, bf16) if name == "qk_norm_rope_bwd" else make(main_shape, bf16)
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args))
        lib_ms = None
        if lib:
            x, sc, dy, _ = args
            xg, scg = x.detach().requires_grad_(True), sc.detach().requires_grad_(True)
            y = F.rms_norm(xg, sc.shape, weight=scg, eps=1e-6)
            lib_ms = time_ms(lambda: torch.autograd.grad(y, (xg, scg), dy, retain_graph=True))
        bound_ms, bound_by = bound(nbytes(*args), flops(*args), PEAK_FLOPS[f32])
        lib_txt = f"F.rms_norm backward {lib_ms:.4f} ms" if lib else "library none"
        print(f"{name} {main_shape} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"{lib_txt}, bound {bound_ms:.5f} ms ({bound_by}, {nbytes(*args) / 1e6:.2f} MB)")
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                     "replaces": "src/repro/kernels/ref.py:67",
                     "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    return rows

def phase_flash_bwd_head_dim(gen, D: int, sweep: list, timed: list) -> list:
    """K1's backward at head dim D against its plain version over the forward's
    sweep at that dim and the training shapes ``timed`` (B, S, H, K, window;
    causal), in both dtypes (bf16: the tensor-core design, at 256 with dK and dV on
    separate warps; f32: the CUDA-core one, at 256 with 32-row tiles), with the
    forward's LSE against the plain LSE and two runs bit-equal; then the bf16
    kernel timed at the training shapes beside its bound, its plain version and
    SDPA's backward (with a boolean band mask where a window applies; the backend
    SDPA took is printed). Returns one entry a shape of ``timed``."""
    from repro_torch.kernels import flash_attention as FA
    f32, bf16 = torch.float32, torch.bfloat16
    cases = sweep + [(B, S, S, H, K, True, w) for B, S, H, K, w in timed]
    worst = {f32: 0.0, bf16: 0.0}
    for B, Sq, Skv, H, K, causal, window in cases:
        for dtype in (f32, bf16):
            tag = f"flash bwd D={D} {B, Sq, Skv, H, K, causal, window} {dtype}"
            q, k, v, do = flash_bwd_inputs(gen, B, Sq, Skv, H, K, D, dtype)
            o, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             return_lse=True)
            _, plain_lse = FA.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                    return_lse=True)
            check(close(lse, plain_lse, TOL[f32]), f"{tag}: lse max err "
                  f"{max_err(lse, plain_lse)}")
            got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window)
            again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                                window=window)
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                window=window)
            for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
                check(close(g, w, FLASH_GRAD_TOL[dtype]), f"{tag} {name}: max err "
                      f"{max_err(g, w)}")
                check(torch.equal(g, a), f"{tag} {name}: two runs differ")
                worst[dtype] = max(worst[dtype], max_err(g, w))
            del q, k, v, do, o, lse, got, again, want
    print(f"flash_attention_bwd D={D}: {len(cases)} cases x f32/bf16 match the plain backward "
          f"(max abs err f32 {worst[f32]:.3g} at tol {FLASH_GRAD_TOL[f32]}, bf16 "
          f"{worst[bf16]:.3g} at tol {FLASH_GRAD_TOL[bf16]}); the forward's LSE matches the "
          f"plain LSE at {TOL[f32]} in both; two runs bit-equal")
    out = []
    for B, S, H, K, window in timed:
        q, k, v, do = flash_bwd_inputs(gen, B, S, S, H, K, D, bf16)
        o, lse = FA.flash_attention_cuda(q, k, v, window=window, return_lse=True)
        got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, window=window)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
        err = max(max_err(g, w) for g, w in zip(got, want))
        ms = time_ms(lambda: FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, window=window))
        plain_ms = time_ms(lambda: FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                                window=window), n=5)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        lib_kw = sdpa_kw(S, window)
        backend = sdpa_backend(qt, kt, vt, **lib_kw)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
        dot = do.transpose(1, 2)
        lib = torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)
        # the library yardstick at the kernel's bf16 gate, widened by sqrt(G / 4) past
        # a GQA group of G = 4 q heads a kv head: at qwen3-moe's 16:1 its dK and dV
        # (sums over the group) missed 2e-2 where the kernel's, summed in f32, held it
        lib_tol = FLASH_GRAD_TOL[bf16] * max(1.0, math.sqrt(H / K / 4))
        lib_err = max(max_err(g.transpose(1, 2), w) for g, w in zip(lib, want))
        lib_need = max(needed_tol(g.transpose(1, 2), w) for g, w in zip(lib, want))
        check(all(close(g.transpose(1, 2), w, lib_tol) for g, w in zip(lib, want)),
              f"SDPA's backward disagrees with plain at D={D} S={S} H={H} K={K} "
              f"window={window}: max err {lib_err} at tolerance {lib_tol}")
        need = max(needed_tol(g, w) for g, w in zip(got, want))
        lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                     retain_graph=True))
        # as phase_backward counts them: q, o, dO read and dq written; k, v read and
        # dk, dv written; lse read, delta written and read
        nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + 3 * B * H * S * 4
        flops = 10 * B * H * D * attn_pairs(S, S, True, window)
        bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[bf16])
        print(f"flash_attention_bwd B={B} S={S} H={H} K={K} D={D} bf16 causal window={window}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms "
              f"({backend}), bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} TFLOP/s, max abs err {err:.3g} "
              f"(SDPA's {lib_err:.3g}); least passing gate {need:.4g} (SDPA's {lib_need:.4g}, "
              f"held at {lib_tol:.4g})")
        out.append({"B": B, "S": S, "H": H, "K": K, "window": window, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms, "library_backend": backend})
        del q, k, v, do, o, lse, got, want, qt, kt, vt, lib_out, lib
    return out


def ssd_bwd_case(gen, B, S, H, P, N, dtype, with_state: bool):
    """x, dt, a, bm, cm, init_state, dy, d(final state) of one K3 backward case;
    the states None without ``with_state`` (the training path's case)."""
    f32 = torch.float32
    return (randn((B, S, H, P), dtype, gen), F.softplus(randn((B, S, H), f32, gen)),
            -torch.exp(0.2 * randn((H,), f32, gen)), randn((B, S, N), dtype, gen),
            randn((B, S, N), dtype, gen),
            randn((B, H, N, P), f32, gen) if with_state else None,
            randn((B, S, H, P), dtype, gen),
            randn((B, H, N, P), f32, gen) if with_state else None)


def gate_ratio(g, w, rtol: float, share: float) -> float:
    """max over elements of |g - w| / (rtol |w| + share max |w|): at most 1 within
    the gate; inf where g is not finite."""
    g, w = g.double(), w.double()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    return ((g - w).abs() / (rtol * w.abs() + share * w.abs().max()).clamp_min(1e-300)
            ).max().item()


def gated_bwd_exact(y, z, sc, dout):
    """The gradient of the f32 gated norm evaluated in f64 from the forward's own
    f32 gate t = y * silu(z): the kernel sums dscale in f64 over that t, and a t
    formed in f64 would differ from it by an f32 rounding in every element."""
    from repro_torch.kernels import rmsnorm as RN
    silu = F.silu(z)
    dt, dscale = RN.rmsnorm_bwd_plain((y * silu).double(), sc.double(), dout.double())
    zd = z.double()
    sig = torch.sigmoid(zd)
    return dt * silu.double(), dt * y.double() * sig * (1 + zd * (1 - sig)), dscale


def ssd_bwd_bytes(args) -> int:
    """Bytes K3's backward must move: x, dy, bm, cm, dt, a (and init_state and
    d(final state)) read once; dx, dbm, dcm, ddt, da (and d(init_state)) written
    once."""
    x, dt, a, bm, cm, h0, dy, _ = args
    state = 0 if h0 is None else 3 * h0.numel() * 4
    return (3 * x.numel() + 2 * (bm.numel() + cm.numel())) * x.element_size() \
        + 2 * (dt.numel() + a.numel()) * 4 + state


def ssd_bwd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Flops of the scan's gradient for these shapes, counted once (the states
    the forward carried taken as given): per chunk, per head dY X^T and the
    intra-chunk dX over the causal pairs, dC and dB from the summed dG once, and
    per head the four state products (dC's and dB's inter-chunk terms, dX's
    readout of dh, dh's update)."""
    total = 0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        pairs = q * (q + 1) // 2
        total += 2 * B * (2 * H * pairs * P + 2 * pairs * N + 4 * H * q * N * P)
    return total


def f64(args):
    """Every float tensor widened to f64 (bf16 values are exact in f64): the
    plain version then gives the exact gradient at these inputs."""
    return [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in args]


SSD_BWD_OUTPUTS = ("dx", "ddt", "da", "dbm", "dcm", "d_init")


def ssd_bwd_held(tag: str, got, want, plain_da, dtype) -> float:
    """K3's backward outputs ``got`` against the plain version in f64 ``want``:
    each within SSD_GRAD_TOL, dA within SSD_DA_TIMES the plain version's own
    distance ``plain_da`` plus the share; returns the worst share of its gate."""
    worst = 0.0
    for name, g, w in zip(SSD_BWD_OUTPUTS, got, want):
        if w is None:
            check(g is None, f"{tag} {name}: given without an init_state")
            continue
        if name == "da":   # as a share of its gate, SSD_DA_TIMES x the plain's
            share = SSD_GRAD_TOL[dtype][1] * w.abs().max().item()
            ratio = max_err(g, w) / (SSD_DA_TIMES * max_err(plain_da, w) + share)
        else:
            ratio = gate_ratio(g, w, *SSD_GRAD_TOL[dtype])
        check(ratio <= 1, f"{tag} {name}: {ratio:.3g} x the gate (max abs err "
              f"{max_err(g, w):.3g}, |grad| max {w.abs().max().item():.3g})")
        worst = max(worst, ratio)
    return worst


def phase_ssm_backward(gen) -> list:
    """The ssm training slice's backward kernels against their plain versions on
    the card, in f32 and bf16, each run twice for bit-equality: K3's backward
    against the plain version evaluated in f64 (SSD_GRAD_TOL, dA by SSD_DA_TIMES)
    on SSD_BWD_SWEEP (the SSD sweep, the backward's own shapes and the training
    shape), with and without init_state and d(final state), and on the conv
    output's strided views; gated_rmsnorm's backward on K2's backward sweep and
    the training shape. Then each is timed at mamba2-2.7b's training shape beside
    its bound and its plain version (no library call computes either); K3's
    backward launch by launch is in the train step's profile (phase_ssm_train:
    a profile here would not be the run's first, which serving's counts need).
    Returns their JSON rows."""
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SS
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {f32: 0.0, bf16: 0.0}
    for B, S, H, P, N, chunk in SSD_BWD_SWEEP:
        for dtype in (f32, bf16):
            for with_state in (False, True):
                tag = f"ssd_scan_bwd {B, S, H, P, N, chunk} {dtype} states={with_state}"
                args = ssd_bwd_case(gen, B, S, H, P, N, dtype, with_state)
                got = SS.ssd_scan_bwd_cuda(*args, chunk=chunk)
                again = SS.ssd_scan_bwd_cuda(*args, chunk=chunk)
                want = SS.ssd_scan_bwd_plain(*f64(args), chunk=chunk)
                plain_da = SS.ssd_scan_bwd_plain(*args, chunk=chunk)[2]
                worst[dtype] = max(worst[dtype], ssd_bwd_held(tag, got, want, plain_da, dtype))
                for name, g, r in zip(SSD_BWD_OUTPUTS, got, again):
                    check(g is None or torch.equal(g, r), f"{tag} {name}: two runs differ")
                del got, again, want
    print(f"ssd_scan_bwd: {len(SSD_BWD_SWEEP)} shapes x f32/bf16 x with/without init_state "
          f"and d(final state) match the plain backward (worst error as a share of its gate, "
          f"rel + share of the largest element {SSD_GRAD_TOL[f32]} / {SSD_GRAD_TOL[bf16]}: "
          f"f32 {worst[f32]:.3g}, bf16 {worst[bf16]:.3g}); two runs bit-equal")

    B, S, H, P, N, chunk = SSD_BWD_MAIN
    args = ssd_bwd_case(gen, B, S, H, P, N, bf16, False)
    x, dt, a, bm, cm, _, dy, _ = args
    got = SS.ssd_scan_bwd_cuda(*args, chunk=chunk)
    want = SS.ssd_scan_bwd_plain(*args, chunk=chunk)
    err = max(max_err(g, w) for g, w in zip(got[:5], want[:5]))
    conv = torch.cat([x.reshape(B, S, H * P), bm, cm], dim=-1)
    views = (conv[..., :H * P].reshape(B, S, H, P), dt, a, conv[..., H * P:H * P + N],
             conv[..., H * P + N:], None, dy, None)
    on_views = SS.ssd_scan_bwd_cuda(*views, chunk=chunk)
    for name, g, w in zip(SSD_BWD_OUTPUTS[:5], on_views[:5], got[:5]):
        check(torch.equal(g, w), f"ssd_scan_bwd on conv-output views: {name} differs from "
              f"contiguous inputs by {max_err(g, w)}")
    ms = time_ms(lambda: SS.ssd_scan_bwd_cuda(*args, chunk=chunk))
    views_ms = time_ms(lambda: SS.ssd_scan_bwd_cuda(*views, chunk=chunk))
    plain_ms = time_ms(lambda: SS.ssd_scan_bwd_plain(*args, chunk=chunk), n=5)
    nbytes, flops = ssd_bwd_bytes(args), ssd_bwd_flops(B, S, H, P, N, chunk)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[bf16])
    print(f"ssd_scan_bwd B={B} S={S} H={H} P={P} N={N} chunk={chunk} bf16: kernel {ms:.4f} ms "
          f"(three launches), plain {plain_ms:.4f} ms, library none, bound {bound_ms:.5f} ms "
          f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"{flops / ms / 1e9:.2f} TFLOP/s, max abs err {err:.3g}; on the conv output's "
          f"strided views {views_ms:.4f} ms, bit-equal")
    rows = [{"name": "ssd_scan_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:27",
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}]
    del got, want, on_views, conv, views, args, x, dy

    # zamba2-7b's training scan (held in the sweep above), timed
    B, S, H, P, N, chunk = SSD_BWD_ZAMBA
    args = ssd_bwd_case(gen, B, S, H, P, N, bf16, False)
    zamba = {"ms": time_ms(lambda: SS.ssd_scan_bwd_cuda(*args, chunk=chunk)),
             "plain_ms": time_ms(lambda: SS.ssd_scan_bwd_plain(*args, chunk=chunk), n=5)}
    nbytes, flops = ssd_bwd_bytes(args), ssd_bwd_flops(B, S, H, P, N, chunk)
    zamba["bound_ms"], zamba["bound_by"] = bound(nbytes, flops, PEAK_FLOPS[bf16])
    print(f"ssd_scan_bwd B={B} S={S} H={H} P={P} N={N} chunk={chunk} bf16 (zamba2-7b): kernel "
          f"{zamba['ms']:.4f} ms (three launches), plain {zamba['plain_ms']:.4f} ms, library "
          f"none, bound {zamba['bound_ms']:.5f} ms ({zamba['bound_by']}; {flops / 1e9:.2f} "
          f"GFLOP, {nbytes / 1e6:.2f} MB)")
    rows[0]["zamba2"] = zamba
    del args
    gc.collect()
    torch.cuda.empty_cache()

    worst = 0.0
    for shape in GATED_BWD_SWEEP:
        for dtype in (f32, bf16):
            y, z, dout = (randn(shape, dtype, gen) for _ in range(3))
            sc = randn(shape[-1:], dtype, gen)
            got = RN.gated_rmsnorm_bwd_cuda(y, z, sc, dout)
            again = RN.gated_rmsnorm_bwd_cuda(y, z, sc, dout)
            want = (gated_bwd_exact(y, z, sc, dout) if dtype == f32
                    else RN.gated_rmsnorm_bwd_plain(y, z, sc, dout))
            for i, (g, w, r) in enumerate(zip(got, want, again)):
                check(close(g, w, RMS_TOL[dtype]), f"gated_rmsnorm_bwd {shape} {dtype} output "
                      f"{i}: max err {max_err(g, w)}")
                check(torch.equal(g, r), f"gated_rmsnorm_bwd {shape} {dtype} output {i}: two "
                      "runs differ")
                if shape == GATED_BWD_SWEEP[-1] and dtype == bf16:
                    worst = max(worst, max_err(g, w))
    print(f"gated_rmsnorm_bwd: matches its plain version on {len(GATED_BWD_SWEEP)} shapes (f32 "
          f"against the f64 evaluation from the forward's f32 gate, bf16; dscale included), "
          f"two runs bit-equal")
    shape = GATED_BWD_SWEEP[-1]
    y, z, dout = (randn(shape, bf16, gen) for _ in range(3))
    sc = randn(shape[-1:], bf16, gen)
    ms = time_ms(lambda: RN.gated_rmsnorm_bwd_cuda(y, z, sc, dout))
    plain_ms = time_ms(lambda: RN.gated_rmsnorm_bwd_plain(y, z, sc, dout))
    nbytes = (5 * y.numel() + 2 * sc.numel()) * y.element_size()   # y, z, dout in; dy, dz out
    bound_ms, bound_by = bound(nbytes, 20 * y.numel(), PEAK_FLOPS[f32])
    print(f"gated_rmsnorm_bwd {shape} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"none, bound {bound_ms:.5f} ms ({bound_by}, {nbytes / 1e6:.2f} MB)")
    rows.append({"name": "gated_rmsnorm_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "replaces": "src/repro/kernels/rmsnorm.py:11",
                 "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None})
    return rows


@contextlib.contextmanager
def router_log(log: list):
    """Each MoE router call's (top-k indices, probabilities) appended to ``log``."""
    from repro_torch.models import moe as MOE
    real = MOE.router_probs

    def logged(cfg, p, x):
        out = real(cfg, p, x)
        log.append((out[1].detach(), out[2].detach()))
        return out

    MOE.router_probs = logged
    try:
        yield log
    finally:
        MOE.router_probs = real


def same_experts(tag: str, got: list, want: list, k: int) -> None:
    """The routers of two runs of one model picked the same experts at every layer,
    exactly, so that a near-tie flip is reported as a flip; prints the smallest
    gap between the k-th and (k+1)-th probability over the run."""
    check(len(got) == len(want), f"{tag}: {len(got)} router calls against {len(want)}")
    gap = math.inf
    for layer, ((got_idx, _), (want_idx, probs)) in enumerate(zip(got, want)):
        top = probs.float().topk(k + 1, dim=-1).values
        layer_gap = (top[..., k - 1] - top[..., k]).min().item()
        gap = min(gap, layer_gap)
        flips = (got_idx.cpu() != want_idx.cpu()).any(-1).sum().item()
        check(flips == 0, f"{tag}: the router picked other experts for {flips} tokens at "
              f"layer {layer} (smallest k-th/(k+1)-th probability gap there {layer_gap:.3g})")
    print(f"{tag}: the same top-{k} experts at all {len(got)} layers; smallest gap between "
          f"the {k}-th and {k + 1}-th router probability {gap:.3g}")


def phase_train_step_parity(arch: str, seq: int, per_step: dict, batch_size: int = 2,
                            cut: dict = None) -> None:
    """One train step of ``arch`` in f32, on the card (the kernels, forward and
    backward) and on the CPU (their plain versions), from the same params and a
    batch of ``batch_size`` x ``seq`` tokens (with random f32 frames or patches
    where the arch reads them, and every vlm gate at CROSS_GATE); the config cut by
    ``cut`` (default: full width, 2 layers). Every parameter leaf must get a
    nonzero gradient on the card: a kernel that dropped a gradient would leave the
    leaves before it without one. Every kernel of ``per_step`` must be launched."""
    from repro_torch import configs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.train_loop import TrainJobConfig
    from repro_torch.tree import tree_flatten_sorted, tree_map

    cut = cut or {"num_layers": 2}
    cfg = dataclasses.replace(configs.get(arch), dtype="float32", remat="none", **cut)
    shape = "full width, 2 layers" if cut == {"num_layers": 2} else \
        ", ".join(f"{k} {v}" for k, v in cut.items())
    opt = TrainJobConfig().opt
    params = with_gates(Model(cfg, "cpu").init_params(0))
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (batch_size, seq + 1), generator=gen).to(torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous(),
             "loss_mask": torch.ones((batch_size, seq), dtype=torch.bfloat16),
             **aux_inputs(cfg, batch_size, gen)}
    card_params = tree_map(lambda t: t.cuda(), params)
    card = {"params": card_params, "opt": init_opt_state(card_params)}
    host = {"params": params, "opt": init_opt_state(params)}

    wrappers = reset_launches()
    with router_log([]) as card_routes:
        card, card_m = make_train_step(Model(cfg, "cuda"), opt, 1)(
            card, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
    t0 = time.perf_counter()
    with router_log([]) as host_routes:
        host, host_m = make_train_step(Model(cfg, "cpu"), opt, 1)(host, batch)
    cpu_s = time.perf_counter() - t0
    if cfg.family == "moe":
        same_experts(f"train step {arch}, card against CPU", card_routes, host_routes,
                     cfg.top_k)
    loss, want_loss = float(card_m["loss"]), float(host_m["loss"])
    gnorm, want_gnorm = float(card_m["grad_norm"]), float(host_m["grad_norm"])
    check(abs(loss - want_loss) <= 1e-4 * (1 + abs(want_loss)),
          f"train step loss {loss} vs CPU {want_loss}")
    check(abs(gnorm - want_gnorm) <= 1e-3 * abs(want_gnorm),
          f"train step grad_norm {gnorm} vs CPU {want_gnorm}")
    # m = (1 - b1) g holds the gradients themselves. The master moves by
    # lr * g / (|g| + eps) at step 1, which turns a gradient difference dg into up
    # to lr * dg / eps where |g| is near eps: the master is held at 1e-4 plus that
    # sensitivity to the measured gradient difference.
    lr = float(card_m["lr"])
    m_err = master_err = 0.0
    beyond = 0
    leaves = zip(*(tree_flatten_sorted(t) for t in (
        card["opt"]["m"], host["opt"]["m"], card["opt"]["master"], host["opt"]["master"])))
    for (path, m), (_, m_cpu), (_, w), (_, w_cpu) in leaves:
        name = "/".join(map(str, path))
        m_cpu, w_cpu = m_cpu.cuda(), w_cpu.cuda()
        check(bool(m.abs().max() > 0), f"train step: leaf {name} got no gradient on the card")
        check(close(m, m_cpu, 1e-6), f"train step: m of {name} max err {max_err(m, m_cpu)}")
        dg = (m - m_cpu).abs() / (1 - opt.b1)
        diff = (w - w_cpu).abs()
        plain_tol = 1e-4 * (1 + w_cpu.abs())
        check(bool((diff <= plain_tol + lr * dg / opt.eps).all()),
              f"train step: master of {name} max err {diff.max().item()}")
        beyond += int((diff > plain_tol).sum())
        m_err, master_err = max(m_err, max_err(m, m_cpu)), max(master_err, diff.max().item())
    print(f"train step, {arch} {shape}, f32, B={batch_size} S={seq}: card loss {loss:.6f} "
          f"grad_norm {gnorm:.6f}, CPU {want_loss:.6f} {want_gnorm:.6f} ({cpu_s:.1f} s); "
          f"max abs err m {m_err:.3g} (at 1e-6), master {master_err:.3g} ({beyond} elements "
          f"beyond 1e-4, each within lr * dg / eps of Adam's first step, lr {lr:.3g}); "
          f"every leaf has a nonzero gradient; launches {launches}")
    for name in per_step:
        check(launches.get(name, 0) > 0, f"train step {arch}: {name} was not launched")


def phase_train(card: str) -> dict:
    """Train qwen3-0.6b at full width through run_train_task with checkpoints,
    evaluate through a strict restore; returns each kernel's launches in the
    train task."""
    from repro_torch.runtime.step_cache import TrainerCache, run_eval_task, run_train_task
    from repro_torch.runtime.train_loop import TrainJobConfig

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    print(f"train: {shutil.disk_usage(build).free / 2**30:.1f} GiB free for checkpoints")
    with tempfile.TemporaryDirectory(dir=build) as ckdir:
        payload = dict(TRAIN, checkpoint_dir=ckdir)
        cache = TrainerCache(1)
        t0 = time.perf_counter()
        trainer = cache.get(TrainJobConfig.from_job({"payload": payload}))  # built cold here
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wrappers = reset_launches()
        t0 = time.perf_counter()
        res = run_train_task(cache, payload)                  # a warm hit: rebound
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        losses = trainer.metrics.series("loss")
        vocab = trainer.arch_cfg.vocab_size
        print(f"train task {TRAIN['arch']} full width, {trainer.arch_cfg.num_layers} layers, "
              f"bf16, {TRAIN['global_batch']} x {TRAIN['seq_len']} tokens a step: {res} in "
              f"{wall:.2f} s (trainer built in {build_s:.2f} s before); losses {losses}; "
              f"launches {launches}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        steps = TRAIN["steps"]
        check(res["steps"] == steps and res["ran_steps"] == steps and len(losses) == steps,
              f"train task: {res}, losses {losses}")
        check(all(math.isfinite(x) for x in losses), f"train task: losses {losses}")
        # on random weights the final-normed hidden state has unit rms and the
        # unembedding std d_model^-1/2 (the init rule), so the logits have
        # variance 1 and the expected CE is ln V + 1/2
        expected = math.log(vocab) + 0.5
        check(abs(losses[0] - expected) < 0.5,
              f"train task: step 1 loss {losses[0]} not within 0.5 of ln({vocab}) + 1/2 = "
              f"{expected:.3f} on random weights")
        check(res["checkpoint"] == {"step": steps, "path": ckdir},
              f"train task checkpoint {res.get('checkpoint')}")
        for name, per in TRAIN_PER_STEP.items():
            check(launches[name] >= per * steps,
                  f"train task: {name} launches {launches[name]} < {per * steps}")
        # the trained state's own loss on the eval task's batch: the eval of the
        # restored checkpoint must give it back
        with torch.no_grad():
            own, _ = trainer.model.loss_fn(trainer.params_for_eval(),
                                           trainer._sync_batch(10_000))
        own = float(own)

        t0 = time.perf_counter()
        ev = run_eval_task(None, {**TRAIN, "restore_from": res["checkpoint"]})
        torch.cuda.synchronize()
        print(f"eval task, strict restore of step {steps}: {ev} in "
              f"{time.perf_counter() - t0:.2f} s; the trained state's own loss on that "
              f"batch {own}")
        check(ev["restored_step"] == steps and math.isfinite(ev["eval_loss"]),
              f"eval task: {ev}")
        check(abs(ev["eval_loss"] - own) <= 1e-5 * abs(own),
              f"eval task: restored loss {ev['eval_loss']} != the trained state's {own}")

    # warm steps of the same trainer, rebound without a checkpoint directory
    trainer = cache.get(TrainJobConfig.from_job({"payload": dict(TRAIN)}))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times[1:])
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    print(f"train step {TRAIN['arch']} full width, {tokens} tokens: {step_ms:.1f} ms (median "
          f"of warm steps {[round(t, 1) for t in times[1:]]}) = {tokens / step_ms * 1e3:.0f} "
          f"training tokens/s [{card}]; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    groups = profile_breakdown(f"{TRAIN['arch']} train step, {tokens} tokens",
                               trainer.step_once, top=10, every=True,
                               groups={"K1 forward": ("flash_fwd",), "K1 backward": K1_BWD_NAMES,
                                       "K2 forward": K2_KERNEL_NAMES,
                                       "K2 backward": K2_BWD_NAMES,
                                       "a separate dscale launch": ("colsum_kernel",),
                                       **{name: (name,) for name in K1_BWD_NAMES}})
    for label in ("K1 backward", "K2 backward"):
        check(label in groups, f"train step profile: no {label} kernels")
    layers = trainer.arch_cfg.num_layers
    for name in K1_BWD_NAMES:       # the bf16 design's kernels, once a layer
        n = groups.get(name, (0.0, 0))[1]
        check(n == layers, f"train step profile: {name} launched {n} times, want {layers}")
    n = groups["K2 backward"][1]
    want = sum(TRAIN_PER_STEP[name] for name in K2_BWD_ENTRIES)
    check(n == want, f"train step profile: {n} K2 backward kernels, want one a call ({want})")
    check("a separate dscale launch" not in groups, "train step profile: K2's backward "
          "launched a separate dscale reduction")
    first_loss = losses[0]
    del trainer, cache
    gc.collect()
    torch.cuda.empty_cache()

    m2 = run_train_task(None, dict(TRAIN, steps=1, microbatches=2))
    print(f"train step with 2 microbatches: loss {m2['loss']:.5f}, 1 microbatch "
          f"{first_loss:.5f} (same params and batch)")
    check(close(torch.tensor(m2["loss"]), torch.tensor(first_loss), 2e-2),
          f"2 microbatches: loss {m2['loss']} vs {first_loss}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_local_plane(card: str) -> dict:
    """The port's local plane and pipeline task handlers at full width, making the
    calls the management plane's control agent makes (capabilities, submit, poll,
    cancel, load). A train job of qwen3-0.6b loses its plane after the step-4
    manifest and resumes on a second plane from it; its steps 5-6 losses are an
    uninterrupted run's, bit for bit. Then the ETL -> train -> eval -> export chain
    through one worker's warm handlers, its eval a cache hit and the strict
    restore of the step-6 manifest, a serve job whose tokens are a direct
    ``Server.run``'s, and one profiled train poll. Returns each kernel's launches
    in the plane's train and serve jobs."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.pipelines import WarmHandlers
    from repro_torch.runtime.local_plane import TorchLocalPlane
    from repro_torch.runtime.serve_loop import Server, ServeJobConfig
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    print(f"plane: {shutil.disk_usage(build).free / 2**30:.1f} GiB free for checkpoints")
    launches = dict.fromkeys(kernel_wrappers(), 0)
    walls, starts, saves, restores, published = {}, {}, {}, [], []

    def count(wrappers) -> None:
        for name, fn in wrappers.items():
            launches[name] += fn.launches

    def publish(jid: str, manifest: dict) -> None:       # runs on the writer's thread
        published.append(dict(manifest))
        saves[manifest["step"]] = time.perf_counter() - starts[manifest["step"]]

    real_save, real_restore = CheckpointManager.save, CheckpointManager.restore

    def timed_save(mgr, step, *args, **kw):
        starts[step] = time.perf_counter()
        return real_save(mgr, step, *args, **kw)

    def timed_restore(mgr, *args, **kw):
        t0 = time.perf_counter()
        out = real_restore(mgr, *args, **kw)
        restores.append(time.perf_counter() - t0)
        return out

    steps, every = PLANE_TRAIN["steps"], PLANE_TRAIN["checkpoint_every"]
    jid = "plane-train"
    job = {"job_id": jid, "kind": "train", "arch": TRAIN["arch"], "payload": PLANE_TRAIN}
    with tempfile.TemporaryDirectory(dir=build) as root, \
            swapped(CheckpointManager, "save", timed_save), \
            swapped(CheckpointManager, "restore", timed_restore):
        # -- a train job loses its plane after the step-4 manifest, resumes on another
        t0 = time.perf_counter()
        plane_a = TorchLocalPlane(caps=PLANE_CAPS, steps_per_poll=2, publish=publish,
                                  device="cuda", checkpoint_root=f"{root}/a")
        check(plane_a.capabilities() == PLANE_CAPS, f"plane caps {plane_a.capabilities()}")
        wrappers = reset_launches()
        plane_a.submit(job)
        polls = []
        while plane_a.jobs[jid].trainer.step < every:
            polls.append(plane_a.poll(jid))
        plane_a.jobs[jid].trainer.ckpt.wait()     # the step-4 writer
        losses_a = plane_a.jobs[jid].trainer.metrics.series("loss")
        manifest = {"step": every, "path": f"{root}/a/{jid}"}
        check(published == [manifest] and plane_a.load() == 1.0,
              f"plane A: published {published}, want {manifest}; polls {polls}")
        plane_a.cancel(jid)
        check(plane_a.poll(jid)["status"] == "failed" and plane_a.load() == 0.0,
              "plane A: the cancelled job still runs")
        del plane_a                                 # the lost cluster, its state freed
        gc.collect()
        torch.cuda.empty_cache()
        plane_b = TorchLocalPlane(caps=PLANE_CAPS, steps_per_poll=2, publish=publish,
                                  device="cuda", checkpoint_root=f"{root}/b")
        plane_b.submit(dict(job, restore_from=manifest))
        shutil.rmtree(manifest["path"])             # restored: A's save is done with
        while polls[-1]["status"] == "running":
            polls.append(plane_b.poll(jid))
        torch.cuda.synchronize()
        count(wrappers)
        walls["train job, lost and resumed"] = time.perf_counter() - t0
        resumed = plane_b.jobs[jid].trainer
        losses_b = resumed.metrics.series("loss")
        final = {"step": steps, "path": f"{root}/b/{jid}"}
        print(f"plane train job {TRAIN['arch']} full width, {resumed.arch_cfg.num_layers} "
              f"layers, {PLANE_TRAIN['global_batch']} x {PLANE_TRAIN['seq_len']} tokens a "
              f"step: polls {polls}; losses on A {losses_a}, on B {losses_b}; published "
              f"{published}")
        check(polls[-1]["status"] == "done" and polls[-1]["progress"] == float(steps)
              and polls[-1]["rate"] == 0.0, f"plane B: last poll {polls[-1]}")
        check(published[1:] == [final], f"plane B: manifests {published}, want {final} last")
        for name, per in TRAIN_PER_STEP.items():
            check(launches[name] == per * steps,
                  f"plane train job: {name} launched {launches[name]}, want {per * steps}")

        t0 = time.perf_counter()
        ref = Trainer(TrainJobConfig.from_job({"payload": PLANE_TRAIN}))
        check(ref.ckpt is None, "plane: the reference run checkpoints")
        ref.run()
        losses_ref = ref.metrics.series("loss")
        walls["uninterrupted run"] = time.perf_counter() - t0
        print(f"plane: uninterrupted run's losses {losses_ref}")
        check(losses_a == losses_ref[:every],
              f"plane: steps 1-{every} on A {losses_a} != uninterrupted {losses_ref[:every]}")
        check(losses_b == losses_ref[every:], f"plane: steps {every + 1}-{steps} resumed "
              f"{losses_b} != uninterrupted {losses_ref[every:]}")
        del ref
        with torch.no_grad():
            own, _ = resumed.model.loss_fn(resumed.params_for_eval(),
                                           resumed._sync_batch(10_000))
        own = float(own)
        del resumed
        gc.collect()
        torch.cuda.empty_cache()

        # -- the pipeline DAG's worker side through one worker's warm handlers: its
        # eval is the strict restore of plane B's step-6 manifest, on the trainer
        # the chain's train task built (a cache hit)
        t0 = time.perf_counter()
        worker = WarmHandlers()
        etl = worker.handlers["etl"]({"batches": 3, "seq_len": 32})
        tr = worker.handlers["train"](dict(PLANE_DAG_TRAIN))
        t1 = time.perf_counter()
        ev = worker.handlers["eval"](dict(PLANE_DAG_TRAIN, restore_from=final))
        torch.cuda.synchronize()
        walls["eval handler"] = time.perf_counter() - t1
        ex = worker.handlers["export"]({"arch": TRAIN["arch"], "reduced": False})
        walls["handler chain"] = time.perf_counter() - t0
        stats = worker.trainer_cache().stats()
        print(f"plane handler chain: etl {etl}; train {tr}; eval, strict restore of step "
              f"{steps}: {ev} (the resumed state's own loss on that batch {own}); export "
              f"{ex}; trainer cache {stats}")
        dag_steps = PLANE_DAG_TRAIN["steps"]
        check(etl == {"batches": 3, "tokens": 3 * 4 * 32}, f"plane etl: {etl}")
        check(tr["steps"] == tr["ran_steps"] == dag_steps and math.isfinite(tr["loss"]),
              f"plane train handler: {tr}")
        check(ev["restored_step"] == steps and math.isfinite(ev["eval_loss"])
              and abs(ev["eval_loss"] - own) <= 1e-5 * abs(own), f"plane eval: {ev}")
        check(stats == {"hits": 1, "misses": 1, "evictions": 0, "size": 1},
              f"plane: eval was not a cache hit on train's trainer: {stats}")
        check(ex == {"exported_params": PATHS[0]["params"], "leaves": 14},
              f"plane export: {ex}")
        del worker
        shutil.rmtree(final["path"])
        gc.collect()
        torch.cuda.empty_cache()

        # -- a serve job on B, against a direct Server.run on the same prompts
        t0 = time.perf_counter()
        wrappers = reset_launches()
        serve = {"job_id": "plane-serve", "kind": "serve", "payload": PLANE_SERVE}
        plane_b.submit(serve)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        spolls = []
        while not spolls or spolls[-1]["status"] == "running":
            spolls.append(plane_b.poll(serve["job_id"]))
        torch.cuda.synchronize()
        walls["serve job"] = time.perf_counter() - t0
        count(wrappers)
        server = plane_b.jobs[serve["job_id"]].server
        n = len(PLANE_SERVE["requests"])
        tokens = sum(len(r.generated) for r in server.requests.values())
        poll_s = walls["serve job"] - build_s
        print(f"plane serve job {TRAIN['arch']} full width, {n} requests of 16 new tokens, "
              f"4 slots: {len(spolls)} polls, last {spolls[-1]}, {server.steps} decode steps, "
              f"{tokens} tokens in {poll_s:.2f} s of polls = {tokens / poll_s:.1f} generated "
              f"tokens/s (server built in {build_s:.2f} s) [{card}]")
        check(spolls[-1]["status"] == "done" and spolls[-1]["served"] == n
              and spolls[-1]["progress"] == float(n) and server.pending() == 0,
              f"plane serve job: {spolls[-1]}")
        pre, dec = n, server.steps
        for name, (per_pre, per_dec) in PATHS[0]["launches"].items():
            want = per_pre * pre + per_dec * dec + TRAIN_PER_STEP.get(name, 0) * steps
            check(launches[name] == want, f"plane: {name} launched {launches[name]} in the "
                  f"train and serve jobs, want {want}")
        check(sum(launches.values()) == sum(TRAIN_PER_STEP.values()) * steps + sum(
            a * pre + b * dec for a, b in PATHS[0]["launches"].values()),
            f"plane: launches {launches}")
        got = [r.generated for r in server.requests.values()]
        del server, plane_b
        gc.collect()
        torch.cuda.empty_cache()
        direct = Server(ServeJobConfig.from_job({"payload": PLANE_SERVE}))
        for r in PLANE_SERVE["requests"]:
            direct.submit(r["prompt"], r["max_new"])
        want = [r.generated for r in direct.run()]
        check(got == want, f"plane serve job tokens {got} != a direct Server.run's {want}")
        del direct
        gc.collect()
        torch.cuda.empty_cache()

        # -- the device-busy share of one poll of a train job (no checkpoints)
        plane_c = TorchLocalPlane(caps=PLANE_CAPS, steps_per_poll=2, device="cuda")
        plane_c.submit({"job_id": "plane-profile", "kind": "train",
                        "payload": dict(PLANE_TRAIN, steps=1000)})
        poll = profile_breakdown(f"{TRAIN['arch']} plane poll, 2 train steps",
                                 lambda: plane_c.poll("plane-profile"))
        busy, n_kernels = poll["all kernels"]
        poll_wall = poll["wall ms"]
        plane_c.cancel("plane-profile")
        del plane_c
        gc.collect()
        torch.cuda.empty_cache()

    gc.collect()
    torch.cuda.empty_cache()
    save_s = {step: round(t, 2) for step, t in saves.items()}
    print(f"plane: walls {({k: round(v, 2) for k, v in walls.items()})} s; saves (start to "
          f"published) {save_s} s; restores {[round(t, 2) for t in restores]} s; one train "
          f"poll (2 steps) device busy {busy:.2f} of {poll_wall:.2f} ms (busy share "
          f"{busy / poll_wall:.3f}), {n_kernels} kernels [{card}]")
    return launches


def load_example(name: str):
    """The module of ``examples/<name>.py``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def served_by(plane, jid: str):
    """The local-plane record (``_TrainJob`` or ``_ServeJob``) of job ``jid``."""
    return plane.agents[plane.job_status(jid)["cluster"]].local_plane.jobs[jid]


def ms_stats(values: list) -> str:
    return (f"median {statistics.median(values):.3f} ms, max {max(values):.3f} ms over "
            f"{len(values)}")


def phase_launchers(card: str) -> dict:
    """The port's entry points as a user runs them, qwen3-0.6b at full width and
    depth: ``repro_torch.launch.train`` in its default driver mode (the port's own
    management plane, a master and 2 private clusters, 30 steps of 8 x 64 tokens,
    checkpoints at 25 and 30 under ``build/``, deleted after), then ``--direct``,
    its losses the driver job's bit for bit; ``launch.serve`` direct and
    ``--driver``, their tokens equal. Every kernel wrapper's launches are held
    exactly over the four runs. Times the host ms each ``plane.tick()`` spends
    outside the local planes' calls (submit, poll, cancel, load), beside those
    calls' own ms, and the train job's seconds from submit to done. Then
    ``examples/torch_quickstart.py`` and ``examples/torch_hybrid_pipeline.py`` run to
    their own asserts (uncounted). Returns each kernel's launches in the four
    launcher runs."""
    from repro_torch.core.plane import ManagementPlane
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.runtime.local_plane import TorchLocalPlane

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    launches = dict.fromkeys(kernel_wrappers(), 0)

    def count(wrappers) -> None:
        for name, fn in wrappers.items():
            launches[name] += fn.launches

    # each tick: (its host ms, {local-plane call: its ms within the tick})
    ticks, local_ms, submitted = [], {}, []
    real_tick, real_submit = ManagementPlane.tick, ManagementPlane.submit_job

    def timed_tick(plane, *args, **kw):
        before, t0 = dict(local_ms), time.perf_counter()
        real_tick(plane, *args, **kw)
        ticks.append(((time.perf_counter() - t0) * 1e3,
                      {k: v - before.get(k, 0.0) for k, v in local_ms.items()}))

    def timed_submit(plane, *args, **kw):
        submitted.append(time.perf_counter())
        return real_submit(plane, *args, **kw)

    def timed_local(name: str):
        real = getattr(TorchLocalPlane, name)

        def call(lp, *args, **kw):
            t0 = time.perf_counter()
            try:
                return real(lp, *args, **kw)
            finally:
                local_ms[name] = local_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return call

    walls = {}
    with contextlib.ExitStack() as stack:
        ck = stack.enter_context(tempfile.TemporaryDirectory(dir=build))
        stack.enter_context(swapped(ManagementPlane, "tick", timed_tick))
        stack.enter_context(swapped(ManagementPlane, "submit_job", timed_submit))
        for name in ("submit", "poll", "cancel", "load"):
            stack.enter_context(swapped(TorchLocalPlane, name, timed_local(name)))
        # -- the train launcher's default driver mode
        wrappers = reset_launches()
        t0 = time.perf_counter()
        out = train_launcher.main(["--checkpoint-dir", ck])
        torch.cuda.synchronize()
        done_at = time.perf_counter()
        count(wrappers)
        walls["train driver"] = done_at - t0
        plane, jid = out["plane"], out["job"]
        status = plane.job_status(jid)
        cross = plane.boundary_report()["cross_cluster_bytes"]
        trainer = served_by(plane, jid).trainer
        trainer.ckpt.wait()                 # the step-30 save is published from its thread
        saved = trainer.ckpt.all_steps()
        losses = trainer.metrics.series("loss")
        train_ticks = list(ticks)
        print(f"launch.train driver: {TRAIN['arch']} full width, "
              f"{trainer.arch_cfg.num_layers} layers, {LAUNCH_BATCH} x {LAUNCH_SEQ} tokens a "
              f"step on {status['cluster']}: status {status}; cross_cluster_bytes {cross}; "
              f"checkpoints at steps {saved}; losses {losses}")
        check(status["status"] == "done" and status["progress"] == float(LAUNCH_STEPS),
              f"launch.train driver: job {status}")
        check(not trainer.cfg.reduced and trainer.device.type == "cuda"
              and trainer.arch_cfg.num_layers == 28, "launch.train driver: not the full model "
              "on the card")
        check(saved == [25, LAUNCH_STEPS], f"launch.train driver: checkpoints {saved}")
        check(len(losses) == LAUNCH_STEPS and all(map(math.isfinite, losses)),
              f"launch.train driver: losses {losses}")
        for name, per in TRAIN_PER_STEP.items():
            check(launches[name] == per * LAUNCH_STEPS, f"launch.train driver: {name} "
                  f"launched {launches[name]}, want {per * LAUNCH_STEPS}")
        check(sum(launches.values()) == sum(TRAIN_PER_STEP.values()) * LAUNCH_STEPS,
              f"launch.train driver: launches {launches}")
        overhead = [total - sum(parts.values()) for total, parts in train_ticks]
        polls = [parts["poll"] for _, parts in train_ticks if parts.get("poll")]
        submit_s = done_at - submitted[0]
        print(f"launch.train driver: plane.tick() outside the local planes' calls "
              f"{ms_stats(overhead)} ticks; the local planes' polls {ms_stats(polls)} "
              f"ticks with one; the job's submit (the trainer's build, in submit_job) "
              f"{local_ms['submit']:.3f} ms; submit to done {submit_s:.3f} s, launcher wall "
              f"{walls['train driver']:.3f} s [{card}]")
        del plane, out, trainer
        gc.collect()
        torch.cuda.empty_cache()

        # -- the same job with --direct: the driver job's losses, bit for bit
        wrappers = reset_launches()
        t0 = time.perf_counter()
        direct = train_launcher.main(["--direct"])["trainer"]
        torch.cuda.synchronize()
        walls["train direct"] = time.perf_counter() - t0
        count(wrappers)
        direct_losses = direct.metrics.series("loss")
        check(direct_losses == losses, f"launch.train --direct losses {direct_losses} != "
              f"the driver job's {losses}")
        del direct
        gc.collect()
        torch.cuda.empty_cache()

        # -- the serve launcher, direct and --driver
        wrappers = reset_launches()
        t0 = time.perf_counter()
        sd = serve_launcher.main([])
        torch.cuda.synchronize()
        walls["serve direct"] = time.perf_counter() - t0
        count(wrappers)
        want = [r.generated for r in sd["done"]]
        steps = {"direct": sd["server"].steps}
        del sd
        gc.collect()
        torch.cuda.empty_cache()
        wrappers = reset_launches()
        t0 = time.perf_counter()
        sp = serve_launcher.main(["--driver"])
        torch.cuda.synchronize()
        walls["serve driver"] = time.perf_counter() - t0
        count(wrappers)
        server = served_by(sp["plane"], sp["job"]).server
        got = [r.generated for r in server.requests.values()]
        steps["driver"] = server.steps
        print(f"launch.serve: direct tokens {want}; driver job {sp['plane'].job_status(sp['job'])}"
              f", decode steps {steps}")
        check(sp["ok"] and got == want, f"launch.serve --driver tokens {got} != direct {want}")
        check(all(len(g) == 8 for g in got) and len(got) == LAUNCH_REQUESTS,
              f"launch.serve: {got}")
        del sp, server
        gc.collect()
        torch.cuda.empty_cache()
    pre, dec = 2 * LAUNCH_REQUESTS, sum(steps.values())
    for name, (per_pre, per_dec) in PATHS[0]["launches"].items():
        want_n = per_pre * pre + per_dec * dec + TRAIN_PER_STEP.get(name, 0) * 2 * LAUNCH_STEPS
        check(launches[name] == want_n, f"launchers: {name} launched {launches[name]}, "
              f"want {want_n}")
    check(sum(launches.values()) == sum(TRAIN_PER_STEP.values()) * 2 * LAUNCH_STEPS + sum(
        a * pre + b * dec for a, b in PATHS[0]["launches"].values()),
        f"launchers: launches {launches}")

    # -- the port's examples, uncounted
    with tempfile.TemporaryDirectory(dir=build) as ck:
        t0 = time.perf_counter()
        load_example("torch_quickstart").main(device="cuda", checkpoint_root=ck)
        torch.cuda.synchronize()
        walls["torch_quickstart"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build) as ck:
        t0 = time.perf_counter()
        load_example("torch_hybrid_pipeline").main(device="cuda", checkpoint_dir=ck)
        torch.cuda.synchronize()
        walls["torch_hybrid_pipeline"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"launchers: walls {({k: round(v, 3) for k, v in walls.items()})} s [{card}]")
    return launches


def phase_phi4(card: str) -> dict:
    """phi4-mini-3.8b through ``repro_torch.launch.serve``'s direct mode at full width
    and depth (6 requests, 4 slots, 8 new tokens), every kernel wrapper's launches
    exactly so many a prefill and a decode step, then prefill + one decode step
    against forward as ``phase_serve`` checks them. Returns the launches."""
    from repro_torch.launch import serve as serve_launcher
    arch = PHI4_PATH["arch"]
    torch.cuda.reset_peak_memory_stats()
    wrappers = reset_launches()
    t0 = time.perf_counter()
    out = serve_launcher.main(["--arch", arch])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    server = out["server"]
    pre, dec = len(out["done"]), server.steps
    print(f"serve launcher {arch}: {pre} requests, {dec} decode steps in {wall:.2f} s (incl. "
          f"param init); launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    check(pre == LAUNCH_REQUESTS and all(len(r.generated) == 8 for r in out["done"]),
          f"{arch}: {[r.generated for r in out['done']]}")
    for name, got in launches.items():
        per_pre, per_dec = PHI4_PATH["launches"].get(name, (0, 0))
        want = per_pre * pre + per_dec * dec
        check(got == want, f"{arch}: {name} launched {got} times, want {want} ({per_pre} a "
              f"prefill, {per_dec} a decode step)")
    model, params = server.model, server.params
    leaves = list(named_leaves(params))
    n_params = sum(t.numel() for _, t in leaves)
    check(n_params == PHI4_PATH["params"] == model.cfg.param_count()
          and model.cfg.num_layers == 32, f"{arch}: params {n_params}")
    check(all(t.is_cuda and t.dtype == torch.bfloat16 for _, t in leaves),
          f"{arch}: params not bf16 on the card")
    forward_checks(arch, model, params, PHI4_PATH)
    del out, server, model, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_ssm_train(card: str) -> dict:
    """Train mamba2-2.7b at full width and depth through run_train_task (2 steps,
    no checkpoint directory), with the launch counters set to 0 just before and
    read just after: every K2 and K3 entry of the path, both ways, exactly
    SSM_TRAIN_PER_STEP a step. Then time warm steps of the same trainer, profile
    one, and check the step-1 loss. Returns each kernel's launches in the task."""
    from repro_torch.runtime.step_cache import TrainerCache, run_train_task
    from repro_torch.runtime.train_loop import TrainJobConfig

    steps = 2
    cache = TrainerCache(1)
    t0 = time.perf_counter()
    trainer = cache.get(TrainJobConfig.from_job({"payload": dict(SSM_TRAIN)}))  # built cold
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = reset_launches()
    t0 = time.perf_counter()
    res = run_train_task(cache, dict(SSM_TRAIN, steps=steps))        # a warm hit: rebound
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    losses = trainer.metrics.series("loss")
    vocab, layers = trainer.arch_cfg.vocab_size, trainer.arch_cfg.num_layers
    print(f"train task {SSM_TRAIN['arch']} full width, {layers} layers, bf16, "
          f"{SSM_TRAIN['global_batch']} x {SSM_TRAIN['seq_len']} tokens a step: {res} in "
          f"{wall:.2f} s (trainer built in {build_s:.2f} s before); losses {losses}; launches "
          f"{launches}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(res["steps"] == steps and len(losses) == steps, f"mamba2 train task: {res}")
    check(all(math.isfinite(v) for v in losses), f"mamba2 train task: losses {losses}")
    expected = math.log(vocab) + 0.5          # random weights: see phase_train
    check(abs(losses[0] - expected) < 0.5,
          f"mamba2 train: step 1 loss {losses[0]} not within 0.5 of ln({vocab}) + 1/2 = "
          f"{expected:.3f} on random weights")
    per_step = ssm_per_step(layers)
    for name, n in launches.items():
        want = per_step.get(name, 0) * steps
        check(n == want, f"mamba2 train task: {name} launched {n} times, want {want}")

    trainer = cache.get(TrainJobConfig.from_job({"payload": dict(SSM_TRAIN)}))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times[1:])
    tokens = SSM_TRAIN["global_batch"] * SSM_TRAIN["seq_len"]
    print(f"train step {SSM_TRAIN['arch']} full width, {layers} layers, {tokens} tokens: "
          f"{step_ms:.1f} ms (median of warm steps {[round(t, 1) for t in times[1:]]}) = "
          f"{tokens / step_ms * 1e3:.0f} training tokens/s [{card}]; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    groups = profile_breakdown(
        f"{SSM_TRAIN['arch']} train step, {tokens} tokens", trainer.step_once, top=12,
        every=True, groups={"K3 forward": ("ssd_scan_kernel", "ssd_scan_bf16_kernel"),
                            "K3 backward": K3_BWD_NAMES, "K2 forward": K2_KERNEL_NAMES,
                            "K2 backward": K2_BWD_NAMES})
    # the backward kernels a step (the counters above hold the forward's launches)
    for label, want in (("K3 backward", 3 * layers), ("K2 backward", 2 * layers + 1)):
        n = groups.get(label, (0.0, 0))[1]
        check(n == want, f"mamba2 train step profile: {n} {label} kernels, want {want}")
    del trainer, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_cut_train(card: str, path: str) -> dict:
    """Train one arch of CUT_TRAINS at full width, cut in depth, bf16, through
    run_train_task (2 steps of one 2,048-token sequence, no checkpoint directory),
    the launch counters set to 0 just before and read just after: every K1, K2 and
    K3 entry of the path, exactly its per_step a step; an MoE arch's aux loss finite
    and within a load-balance loss's range at step 1. Then 3 warm steps of the same
    trainer timed and one profiled: each of K1's bf16 backward kernels at the path's
    head dim once a shared attention block (gemma3: each layer), and no other K1
    backward kernel; K2's and K3's backward kernels once an entry. No checkpointed
    task: a save at these depths is ~22-47 GB, and the task code is qwen3's and
    mamba2's. Returns each kernel's launches in the task."""
    from repro_torch.runtime.step_cache import TrainerCache, run_train_task
    from repro_torch.runtime.train_loop import TrainJobConfig

    spec = CUT_TRAINS[path]
    job, per_step, steps = spec["job"], spec["per_step"], 2
    arch = job["arch"]
    with arch_depth(arch, spec["layers"]):
        torch.cuda.reset_peak_memory_stats()
        cache = TrainerCache(1)
        t0 = time.perf_counter()
        trainer = cache.get(TrainJobConfig.from_job({"payload": dict(job)}))  # cold
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        state_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        wrappers = reset_launches()
        t0 = time.perf_counter()
        res = run_train_task(cache, dict(job, steps=steps))        # a warm hit: rebound
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = trainer.metrics.series("loss")
    vocab, layers = trainer.arch_cfg.vocab_size, trainer.arch_cfg.num_layers
    print(f"train task {arch} full width, {layers} layers, bf16, "
          f"{job['global_batch']} x {job['seq_len']} tokens a step: {res} in "
          f"{wall:.2f} s (trainer built in {build_s:.2f} s before: {state_gib:.2f} GiB "
          f"allocated); losses {losses}; launches {launches}; peak memory {peak_gib:.2f} GiB "
          f"of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} [{card}]")
    check(layers == spec["layers"], f"{path}: {layers} layers, want {spec['layers']}")
    check(res["steps"] == steps and res["ran_steps"] == steps and len(losses) == steps,
          f"{path} task: {res}")
    check(all(math.isfinite(v) for v in losses), f"{path} task: losses {losses}")
    expected = math.log(vocab) + 0.5          # random weights: see phase_train
    check(abs(losses[0] - expected) < 0.5,
          f"{path}: step 1 loss {losses[0]} not within 0.5 of ln({vocab}) + 1/2 = "
          f"{expected:.3f} on random weights")
    if trainer.arch_cfg.family == "moe":
        # the layers' summed load-balance losses: a layer's E * sum_e f_e p_e is K
        # when its router spreads the K picks evenly, at most E when every token
        # picks the same K experts; so a layer's share a pick lies in [~1, E / K]
        aux = trainer.metrics.series("aux_loss")
        E, K = trainer.arch_cfg.num_experts, trainer.arch_cfg.top_k
        per_pick = aux[0] / (layers * K)
        print(f"{path}: aux_loss {aux}; step 1 over {layers} layers x top-{K}: "
              f"{per_pick:.4f} (1: balanced; {E / K:.2f}: every token on the same {K})")
        check(all(math.isfinite(a) for a in aux) and 0.5 <= per_pick <= E / K,
              f"{path}: aux_loss {aux}, {per_pick} a layer and pick at step 1, outside "
              f"[0.5, {E / K:.2f}]")
    for name, n in launches.items():
        want = per_step.get(name, 0) * steps
        check(n == want, f"{path} task: {name} launched {n} times, want {want}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    tokens = job["global_batch"] * job["seq_len"]
    print(f"train step {arch} full width, {layers} layers, {tokens} tokens: "
          f"{step_ms:.1f} ms (median of warm steps {[round(t, 1) for t in times]}) = "
          f"{tokens / step_ms * 1e3:.0f} training tokens/s [{card}]; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    groups = profile_breakdown(
        f"{arch} train step, {layers} layers, {tokens} tokens", trainer.step_once, top=12,
        every=True,
        groups={"K1 forward": ("flash_fwd",),
                "K1 backward": K1_BWD_NAMES + K1_BWD_256_NAMES + K1_BWD_F32_NAMES,
                "K2 forward": K2_KERNEL_NAMES, "K2 backward": K2_BWD_NAMES,
                "K3 forward": ("ssd_scan_kernel", "ssd_scan_bf16_kernel"),
                "K3 backward": K3_BWD_NAMES,
                **{name: (name,) for name in spec["k1_bwd"]}})
    # the backward kernels a step (the counters above hold the wrappers' calls)
    attn = per_step["flash_attention"]          # attention layers a step
    n = groups.get("K1 backward", (0.0, 0))[1]
    check(n == 3 * attn, f"{path} step profile: {n} K1 backward kernels, want {3 * attn} "
          f"(three an attention layer, no other)")
    for name in spec["k1_bwd"]:
        n = groups.get(name, (0.0, 0))[1]
        check(n == attn, f"{path} step profile: {name} launched {n} times, want {attn}")
    for key, n in groups["by name"].items():
        if re.search(r"\bbwd_(dq|dkdv|dkdv_split)_bf16_kernel", key):
            check(f"<{spec['head_dim']}>" in key, f"{path} step profile: {key} is not the "
                  f"head-dim-{spec['head_dim']} instance")
    n = groups.get("K2 backward", (0.0, 0))[1]
    want = sum(per_step.get(name, 0) for name in K2_BWD_ENTRIES + ("gated_rmsnorm_bwd",))
    check(n == want, f"{path} step profile: {n} K2 backward kernels, want {want}")
    n = groups.get("K3 backward", (0.0, 0))[1]
    check(n == 3 * per_step.get("ssd_scan_bwd", 0), f"{path} step profile: {n} K3 backward "
          f"kernels, want {3 * per_step.get('ssd_scan_bwd', 0)}")
    del trainer, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def pods_synced(state) -> bool:
    """Every pod's params are the master cast to their dtype, bit for bit."""
    from repro_torch.tree import tree_flatten_sorted
    return all(torch.equal(pods[p], master.to(pods.dtype))
               for (_, pods), (_, master) in zip(tree_flatten_sorted(state["pod_params"]),
                                                 tree_flatten_sorted(state["master"]))
               for p in range(pods.shape[0]))


def phase_local_sgd_parity() -> None:
    """One f32 local-SGD round of qwen3-0.6b at full width and 2 layers, 2 pods, H =
    2, on the card (the kernels, both ways) and on the CPU (their plain versions),
    from the same params and batches, with int8 compression on and off; the round
    is ``make_round_fn``'s, its outer step watched for the state it starts from.
    Held at the sync step's gates (phase_train_step_parity), with Adam's term over
    the H steps: the pods' m at 1e-6; their masters before the outer step at 1e-4
    plus H lr dg / eps; momentum and master at 1e-4 plus that term's pod mean
    through the outer step. With compression, each int8 delta element is formed on
    both sides from their own inputs. Where the two lie less than half a step
    apart, one may round to the next value (never further) across a rounding
    boundary, in at most LOCAL_SGD_FLIP_SHARE of the elements; where Adam's term
    set the pods' masters further apart, the int8 values differ by as many steps
    as lie between them. Where they differ, and only there, the gates of ef,
    momentum and master take one int8 step more. Every kernel of the path is
    launched, exactly so many times a round."""
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.optim import local_sgd as LS
    from repro_torch.optim.compression import quantize_int8
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.runtime.train_loop import TrainJobConfig
    from repro_torch.tree import tree_flatten_sorted, tree_map

    P, H, S = (LOCAL_SGD_PARITY[k] for k in ("n_pods", "inner_steps", "seq"))
    cfg = dataclasses.replace(configs.get("qwen3-0.6b"), dtype="float32", remat="none",
                              num_layers=2)
    opt = TrainJobConfig().opt
    params = Model(cfg, "cpu").init_params(0)
    gen = torch.Generator().manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (H, P, 1, S + 1), generator=gen).to(torch.int32)
    batches = {"tokens": toks[..., :-1].contiguous(), "targets": toks[..., 1:].contiguous(),
               "loss_mask": torch.ones((H, P, 1, S), dtype=torch.bfloat16)}
    # the inner lr rises through the warmup: its last step's is each step's bound
    lr = float(warmup_cosine(H, peak_lr=opt.peak_lr, warmup_steps=opt.warmup_steps,
                             total_steps=opt.total_steps))
    leaves = lambda tree: [t for _, t in tree_flatten_sorted(tree)]  # noqa: E731
    for compress in (True, False):
        lcfg = LS.LocalSGDConfig(inner_steps=H, compress=compress)
        runs = {}
        for dev in ("cuda", "cpu"):
            state = LS.init_local_sgd_state(tree_map(lambda t: t.to(dev), params), P)
            start = {}
            real = LS.outer_step

            def watched(st, c, start=start, real=real):
                start.update(pod_master=tree_map(torch.clone, st["pod_opt"]["master"]),
                             master=tree_map(torch.clone, st["master"]),
                             ef=tree_map(torch.clone, st["ef"]))
                return real(st, c)

            wrappers = reset_launches()
            t0 = time.perf_counter()
            with swapped(LS, "outer_step", watched):
                state, m = LS.make_round_fn(Model(cfg, dev), opt, lcfg)(
                    state, {k: v.to(dev) for k, v in batches.items()})
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
            runs[dev] = (state, start, float(m["delta_norm"]), time.perf_counter() - t0)
        (card, c0, c_norm, card_s), (host, h0, h_norm, cpu_s) = runs["cuda"], runs["cpu"]
        gain = lcfg.outer_lr * (1 + lcfg.outer_momentum) if lcfg.nesterov else lcfg.outer_lr
        err = dict.fromkeys(("m", "pod masters", "ef", "momentum", "master"), 0.0)
        beyond = flips = wide = total = 0
        for (path, m_c), m_h, pm_c, pm_h, w0, ef0_c, ef0_h, ef_c, ef_h, mo_c, mo_h, w_c, w_h, \
                pods in zip(tree_flatten_sorted(card["pod_opt"]["m"]), *(leaves(t) for t in (
                    host["pod_opt"]["m"], c0["pod_master"], h0["pod_master"], c0["master"],
                    c0["ef"], h0["ef"], card["ef"], host["ef"], card["momentum"],
                    host["momentum"], card["master"], host["master"], card["pod_params"]))):
            name = "/".join(map(str, path))
            m_h, pm_h, ef0_h, ef_h, mo_h, w_h = (t.cuda() for t in (m_h, pm_h, ef0_h, ef_h,
                                                                    mo_h, w_h))
            check(bool(m_c.abs().max() > 0), f"local SGD round: leaf {name} got no gradient")
            check(close(m_c, m_h, 1e-6), f"local SGD round: m of {name} max err "
                  f"{max_err(m_c, m_h)}")
            adam = H * lr * (m_c - m_h).abs() / (1 - opt.b1) / opt.eps
            plain = 1e-4 * (1 + pm_h.abs())
            diff = (pm_c - pm_h).abs()
            check(bool((diff <= plain + adam).all()), f"local SGD round: pod masters of {name} "
                  f"max err {diff.max().item()}")
            beyond += int((diff > plain).sum())
            step = torch.zeros_like(adam)             # one int8 step where one rounded otherwise
            if compress:
                for p in range(P):
                    v_c, v_h = w0 - pm_c[p] + ef0_c[p], w0 - pm_h[p] + ef0_h[p]
                    (q_c, s_c), (q_h, s_h) = quantize_int8(v_c), quantize_int8(v_h)
                    dq = (q_c.int() - q_h.int()).abs()
                    # less than half a step apart, the two sides' deltas round to the same
                    # or the next int8 value: the next one only across a rounding boundary
                    near = (v_c - v_h).abs() < s_h / 2
                    check(bool((dq[near] <= 1).all()) and bool(
                        (dq <= (v_c / s_c - v_h / s_h).abs() + 1).all()),
                        f"local SGD round: int8 delta of {name} pod {p} off by {int(dq.max())} "
                        f"steps")
                    step[p] = (dq > 0) * 1.01 * s_h
                    flips += int((near & (dq == 1)).sum())
                    wide += int((~near & (dq > 0)).sum())
            total += pm_c.numel()
            diff = (ef_c - ef_h).abs()
            check(bool((diff <= plain + adam + step).all()),
                  f"local SGD round: ef of {name} max err {diff.max().item()}")
            term = (adam + step).mean(0)
            for key, got, want, allow in (("momentum", mo_c, mo_h, term),
                                          ("master", w_c, w_h, gain * term)):
                diff = (got - want).abs()
                check(bool((diff <= 1e-4 * (1 + want.abs()) + allow).all()),
                      f"local SGD round: {key} of {name} max err {diff.max().item()}")
                err[key] = max(err[key], diff.max().item())
            for key, a, b in (("m", m_c, m_h), ("pod masters", pm_c, pm_h), ("ef", ef_c, ef_h)):
                err[key] = max(err[key], max_err(a, b))
            check(all(torch.equal(pods[p], w_c) for p in range(P)),
                  f"local SGD round: a pod's params of {name} are not the master")
        check(flips <= LOCAL_SGD_FLIP_SHARE * total,
              f"local SGD round: {flips} of {total} int8 elements rounded otherwise")
        check(abs(c_norm - h_norm) <= 1e-4 * h_norm,
              f"local SGD round: delta_norm {c_norm} vs CPU {h_norm}")
        per_round = {n: k * P * H for n, k in dense_per_step(cfg.num_layers).items()}
        check(launches == per_round, f"local SGD round: launches {launches}, want {per_round}")
        print(f"local SGD round, qwen3-0.6b full width, 2 layers, f32, {P} pods x H={H} x "
              f"1 x {S} tokens, {'int8 + error feedback' if compress else 'f32 exchange'}: "
              f"card delta_norm {c_norm:.6f}, CPU {h_norm:.6f} (card {card_s:.1f} s, CPU "
              f"{cpu_s:.1f} s); max abs err "
              + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
              + f"; {beyond} pod-master elements beyond 1e-4, each within H lr dg / eps "
              f"(lr {lr:.3g}); {flips} of {total} int8 elements rounded to the next value "
              f"across a rounding boundary ({flips / total:.2e}, allowed "
              f"{LOCAL_SGD_FLIP_SHARE:g}), {wide} more where the pods' masters differ by half "
              f"an int8 step or more; pods bit-equal to the master; launches {launches}")
        del card, host, c0, h0, runs
        gc.collect()
        torch.cuda.empty_cache()


def phase_local_sgd_train(card: str) -> dict:
    """Train qwen3-0.6b at full width and depth in local_sgd mode through
    run_train_task (2 rounds of 2 pods x H = 4 inner steps, no checkpoint
    directory), the launch counters set to 0 just before and read just after:
    every K1 and K2 entry, both ways, exactly dense_per_step(28) x P x H a round;
    every pod's params bit-equal to the master cast to bf16 after each round. Then
    the master's eval loss (``run_eval_task``'s computation; the task itself
    would need a 30.8 GiB save to restore) finite. Then 3 warm rounds timed, the
    outer step alone timed, one round and one outer step profiled, and the byte
    accounting printed. Returns each kernel's launches in the task."""
    from repro_torch.optim import local_sgd as LS
    from repro_torch.runtime.step_cache import TrainerCache, run_train_task
    from repro_torch.runtime.train_loop import TrainJobConfig

    job = LOCAL_SGD
    P, H = job["n_pods"], job["local_sgd"]["inner_steps"]
    rounds = job["steps"] // H
    cache = TrainerCache(1)
    t0 = time.perf_counter()
    trainer = cache.get(TrainJobConfig.from_job({"payload": dict(job)}))  # built cold here
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state_gib = torch.cuda.memory_allocated() / 2**30
    real_round, synced = trainer.round_fn, []

    def checked(state, batches):
        state, m = real_round(state, batches)
        synced.append(pods_synced(state))
        return state, m

    trainer.round_fn = checked
    torch.cuda.reset_peak_memory_stats()
    wrappers = reset_launches()
    t0 = time.perf_counter()
    res = run_train_task(cache, dict(job))                      # a warm hit: rebound
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    trainer.round_fn = real_round
    norms = trainer.metrics.series("delta_norm")
    layers = trainer.arch_cfg.num_layers
    print(f"local SGD train task {job['arch']} full width, {layers} layers, bf16, {P} pods x "
          f"H={H} x {job['global_batch'] // P} x {job['seq_len']} tokens: {res} in {wall:.2f} s "
          f"(trainer built in {build_s:.2f} s before: {state_gib:.2f} GiB allocated); "
          f"delta_norm {norms}; launches {launches}; peak memory {peak_gib:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} [{card}]")
    check(layers == 28, f"local SGD train: {layers} layers, want 28")
    check(res["steps"] == job["steps"] and res["ran_steps"] == job["steps"]
          and res["loss"] is None, f"local SGD train task: {res}")
    check(synced == [True] * rounds, f"local SGD train: pods synced after each round {synced}")
    check(len(norms) == rounds and all(math.isfinite(v) and v > 0 for v in norms),
          f"local SGD train: delta_norm {norms}")
    check(int(trainer.state["round"]) == rounds
          and trainer.state["pod_opt"]["step"].tolist() == [job["steps"]] * P,
          f"local SGD train: round {trainer.state['round']}, pod steps "
          f"{trainer.state['pod_opt']['step']}")
    per_step = dense_per_step(layers)
    for name, n in launches.items():
        want = per_step.get(name, 0) * P * H * rounds
        check(n == want, f"local SGD train task: {name} launched {n} times, want {want}")
    with torch.no_grad():            # run_eval_task's loss, on the task's trained master
        own, _ = trainer.model.loss_fn(trainer.params_for_eval(), trainer._sync_batch(10_000))
    print(f"local SGD: the master's eval loss after the task's {trainer.step} steps "
          f"{float(own):.5f}")
    check(math.isfinite(float(own)), f"local SGD: eval loss {own}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(pods_synced(trainer.state), "local SGD: pods not synced after a warm round")
    round_ms = statistics.median(times)
    tokens = job["global_batch"] * job["seq_len"] * H
    outer = lambda: LS.outer_step(trainer.state, trainer.cfg.local_sgd)  # noqa: E731
    outer_ms = wall_ms(outer, n=3)
    print(f"local SGD round {job['arch']} full width, {tokens} tokens: {round_ms:.1f} ms (median "
          f"of warm rounds {[round(t, 1) for t in times]}) = {tokens / round_ms * 1e3:.0f} "
          f"training tokens/s; outer step alone {outer_ms:.1f} ms [{card}]; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    groups = profile_breakdown(
        f"{job['arch']} local SGD round, {tokens} tokens", trainer.step_once, top=12,
        groups={"K1 forward": ("flash_fwd",), "K1 backward": K1_BWD_NAMES,
                "K2 forward": K2_KERNEL_NAMES, "K2 backward": K2_BWD_NAMES})
    pod_steps = P * H
    n = groups.get("K1 backward", (0.0, 0))[1]
    check(n == 3 * layers * pod_steps, f"local SGD round profile: {n} K1 backward kernels, "
          f"want {3 * layers * pod_steps}")
    n = groups.get("K2 backward", (0.0, 0))[1]
    want = sum(per_step[name] for name in K2_BWD_ENTRIES) * pod_steps
    check(n == want, f"local SGD round profile: {n} K2 backward kernels, want {want}")
    profile_breakdown(f"{job['arch']} local SGD outer step", outer, top=8, groups={})
    c_bytes, sync_bytes = LS.dcn_bytes_per_round(trainer.state["master"], trainer.cfg.local_sgd)
    f32_bytes, _ = LS.dcn_bytes_per_round(
        trainer.state["master"], dataclasses.replace(trainer.cfg.local_sgd, compress=False))
    print(f"local SGD bytes across the pod boundary a round: {c_bytes / 1e9:.3f} GB int8 "
          f"({f32_bytes / 1e9:.3f} GB as f32), against {sync_bytes / 1e9:.3f} GB of bf16 "
          f"gradients that synchronous data parallelism all-reduces over the same {H} steps "
          f"({sync_bytes / c_bytes:.2f}x)")
    del trainer, cache, real_round, outer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_local_sgd_task() -> None:
    """The local-SGD train task with a checkpoint (8 steps, a checkpoint every 8)
    and a strict eval-task restore of it, at full width and LOCAL_SGD_TASK_LAYERS
    layers: the restored master's eval loss is the trained state's own."""
    from repro_torch.runtime.step_cache import TrainerCache, run_eval_task, run_train_task
    from repro_torch.runtime.train_loop import TrainJobConfig

    job = dict(LOCAL_SGD, checkpoint_every=LOCAL_SGD["steps"])
    P, H = job["n_pods"], job["local_sgd"]["inner_steps"]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    print(f"local SGD task: {shutil.disk_usage(build).free / 2**30:.1f} GiB free for "
          f"checkpoints")
    with arch_depth(job["arch"], LOCAL_SGD_TASK_LAYERS), \
            tempfile.TemporaryDirectory(dir=build) as ckdir:
        payload = dict(job, checkpoint_dir=ckdir)
        cache = TrainerCache(1)
        trainer = cache.get(TrainJobConfig.from_job({"payload": payload}))
        wrappers = reset_launches()
        t0 = time.perf_counter()
        res = run_train_task(cache, payload)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
        layers = trainer.arch_cfg.num_layers
        manifest = json.loads((Path(ckdir) / f"step_{job['steps']:08d}" / "manifest.json")
                              .read_text())
        save_gb = sum(os.path.getsize(Path(ckdir) / f"step_{job['steps']:08d}" / e["file"])
                      for e in manifest["leaves"].values()) / 1e9
        print(f"local SGD train task {job['arch']} full width, {layers} layers: {res} in "
              f"{wall:.2f} s ({save_gb:.2f} GB a save); delta_norm "
              f"{trainer.metrics.series('delta_norm')}; launches {launches}")
        check(layers == LOCAL_SGD_TASK_LAYERS, "local SGD task: depth not cut")
        check(res["steps"] == job["steps"] and res["ran_steps"] == job["steps"]
              and res["loss"] is None, f"local SGD task: {res}")
        check(res["checkpoint"] == {"step": job["steps"], "path": ckdir},
              f"local SGD task checkpoint {res.get('checkpoint')}")
        check(manifest["extra"]["mode"] == "local_sgd" and "pod_opt/step" in manifest["leaves"],
              f"local SGD task: manifest extra {manifest['extra']}")
        for name, per in dense_per_step(layers).items():
            want = per * P * job["steps"]
            check(launches.get(name, 0) == want,
                  f"local SGD task: {name} launched {launches.get(name, 0)}, want {want}")
        with torch.no_grad():
            own, _ = trainer.model.loss_fn(trainer.params_for_eval(),
                                           trainer._sync_batch(10_000))
        own = float(own)
        t0 = time.perf_counter()
        ev = run_eval_task(None, {**job, "restore_from": res["checkpoint"]})
        torch.cuda.synchronize()
        print(f"local SGD eval task, strict restore of step {job['steps']}: {ev} in "
              f"{time.perf_counter() - t0:.2f} s; the trained master's own loss on that "
              f"batch {own}")
        check(ev["restored_step"] == job["steps"] and math.isfinite(ev["eval_loss"]),
              f"local SGD eval task: {ev}")
        check(abs(ev["eval_loss"] - own) <= 1e-5 * abs(own),
              f"local SGD eval task: restored loss {ev['eval_loss']} != the trained {own}")
        del trainer, cache
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def arch_depth(arch: str, layers: int):
    """``configs.get(arch)`` with ``num_layers`` cut to ``layers`` (full width),
    for the tasks, which name an arch and build their config from the registry."""
    from repro_torch import configs
    real = configs.get

    def cut(name):
        cfg = real(name)
        return dataclasses.replace(cfg, num_layers=layers) if name == arch else cfg

    configs.get = cut
    try:
        yield
    finally:
        configs.get = real


def phase_ssm_tasks() -> None:
    """The mamba2-2.7b train task (4 steps, a checkpoint every 2) and a strict
    eval-task restore of its last checkpoint, at full width and SSM_TASK_LAYERS
    layers (a full-depth save is ~39.6 GB, three a task)."""
    from repro_torch.runtime.step_cache import TrainerCache, run_eval_task, run_train_task
    from repro_torch.runtime.train_loop import TrainJobConfig

    steps = 4
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with arch_depth(SSM_TRAIN["arch"], SSM_TASK_LAYERS), \
            tempfile.TemporaryDirectory(dir=build) as ckdir:
        payload = dict(SSM_TRAIN, steps=steps, checkpoint_every=2, checkpoint_dir=ckdir)
        cache = TrainerCache(1)
        trainer = cache.get(TrainJobConfig.from_job({"payload": payload}))
        wrappers = reset_launches()
        t0 = time.perf_counter()
        res = run_train_task(cache, payload)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
        losses = trainer.metrics.series("loss")
        print(f"train task {SSM_TRAIN['arch']} full width, {trainer.arch_cfg.num_layers} "
              f"layers: {res} in {wall:.2f} s; losses {losses}; launches {launches}")
        check(trainer.arch_cfg.num_layers == SSM_TASK_LAYERS, "mamba2 task: depth not cut")
        check(res["steps"] == steps and res["ran_steps"] == steps and len(losses) == steps
              and all(math.isfinite(v) for v in losses), f"mamba2 train task: {res}")
        check(res["checkpoint"] == {"step": steps, "path": ckdir},
              f"mamba2 train task checkpoint {res.get('checkpoint')}")
        for name, per in ssm_per_step(SSM_TASK_LAYERS).items():
            want = per * steps
            check(launches.get(name, 0) == want,
                  f"mamba2 train task: {name} launched {launches.get(name, 0)}, want {want}")
        with torch.no_grad():
            own, _ = trainer.model.loss_fn(trainer.params_for_eval(),
                                           trainer._sync_batch(10_000))
        own = float(own)
        t0 = time.perf_counter()
        ev = run_eval_task(None, {**SSM_TRAIN, "restore_from": res["checkpoint"]})
        torch.cuda.synchronize()
        print(f"eval task {SSM_TRAIN['arch']}, strict restore of step {steps}: {ev} in "
              f"{time.perf_counter() - t0:.2f} s; the trained state's own loss on that "
              f"batch {own}")
        check(ev["restored_step"] == steps and math.isfinite(ev["eval_loss"]),
              f"mamba2 eval task: {ev}")
        check(abs(ev["eval_loss"] - own) <= 1e-5 * abs(own),
              f"mamba2 eval task: restored loss {ev['eval_loss']} != the trained state's {own}")
        del trainer, cache
    gc.collect()
    torch.cuda.empty_cache()


def phase_encdec_task() -> None:
    """whisper-medium's train task at full width and depth with a checkpoint (2
    steps, a checkpoint every 2; a save is ~14 GB) and a strict eval-task restore of
    it: the launches exactly 2 steps' (the encoder's included), the restored
    state's eval loss on the Trainer's frames the trained state's own."""
    from repro_torch.runtime.step_cache import TrainerCache, run_eval_task, run_train_task
    from repro_torch.runtime.train_loop import TrainJobConfig

    steps = 2
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    print(f"whisper task: {shutil.disk_usage(build).free / 2**30:.1f} GiB free for checkpoints")
    with tempfile.TemporaryDirectory(dir=build) as ckdir:
        payload = dict(WHISPER_TRAIN, steps=steps, checkpoint_every=2, checkpoint_dir=ckdir)
        cache = TrainerCache(1)
        trainer = cache.get(TrainJobConfig.from_job({"payload": payload}))
        wrappers = reset_launches()
        t0 = time.perf_counter()
        res = run_train_task(cache, payload)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
        losses = trainer.metrics.series("loss")
        step_dir = Path(ckdir) / f"step_{steps:08d}"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        save_gb = sum(os.path.getsize(step_dir / e["file"])
                      for e in manifest["leaves"].values()) / 1e9
        print(f"train task {WHISPER_TRAIN['arch']} full width, "
              f"{trainer.arch_cfg.encoder_layers} + {trainer.arch_cfg.num_layers} layers, "
              f"checkpointed: {res} in {wall:.2f} s ({save_gb:.2f} GB a save); losses "
              f"{losses}; launches {launches}")
        check(res["steps"] == steps and res["ran_steps"] == steps and len(losses) == steps
              and all(math.isfinite(v) for v in losses), f"whisper train task: {res}")
        check(res["checkpoint"] == {"step": steps, "path": ckdir},
              f"whisper train task checkpoint {res.get('checkpoint')}")
        check({"params/enc_norm", "params/layers/xattn/wk"} <= set(manifest["leaves"]),
              f"whisper checkpoint leaves {sorted(manifest['leaves'])[:8]}")
        for name, per in encdec_per_step(WHISPER_LAYERS, WHISPER_LAYERS).items():
            want = per * steps
            check(launches.get(name, 0) == want,
                  f"whisper train task: {name} launched {launches.get(name, 0)}, want {want}")
        with torch.no_grad():
            own, _ = trainer.model.loss_fn(trainer.params_for_eval(),
                                           trainer._sync_batch(10_000))
        own = float(own)
        t0 = time.perf_counter()
        ev = run_eval_task(None, {**WHISPER_TRAIN, "restore_from": res["checkpoint"]})
        torch.cuda.synchronize()
        print(f"eval task {WHISPER_TRAIN['arch']}, strict restore of step {steps}: {ev} in "
              f"{time.perf_counter() - t0:.2f} s; the trained state's own loss on that "
              f"batch {own}")
        check(ev["restored_step"] == steps and math.isfinite(ev["eval_loss"]),
              f"whisper eval task: {ev}")
        check(abs(ev["eval_loss"] - own) <= 1e-5 * abs(own),
              f"whisper eval task: restored loss {ev['eval_loss']} != the trained state's {own}")
        del trainer, cache
    gc.collect()
    torch.cuda.empty_cache()


def build_other(checkout: Path, name: str):
    """csrc/<name>.cu of another checkout (its root, e.g. the parent commit
    unpacked by ``git archive``), built with this checkout's nvcc flags into a
    library of its own; returns (the loaded library, its ptxas kernels)."""
    from repro_torch.kernels import _build
    src = checkout.resolve() / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    lib = _build.BUILD_DIR / f"other-{name}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         check=True, capture_output=True, text=True, timeout=600)
    print(f"built {src}")
    return ctypes.CDLL(str(lib)), ptxas_kernels(out.stdout + out.stderr)


def sass_functions(lib: Path) -> dict:
    """{mangled kernel name: its SASS} of a built library, from ``cuobjdump -sass``
    (instruction offsets are relative to each function, so equal code prints equal;
    runs of blanks are cut to one, since cuobjdump pads its columns to the widest
    instruction of the whole library); the anonymous namespace's prefix, which the
    compiler derives from the file, is cut from each name."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], check=True, capture_output=True,
                         text=True, timeout=300).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", m.group(1))
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(" ".join(line.split()))
    return {n: "\n".join(lines) for n, lines in funcs.items()}


# K2's gated entries timed in turns against the other checkout: mamba2-2.7b's prefill
# of 512 tokens (forward) and training shape (backward), bf16
GATED_TURNS = (1, 512, 5120), (1, 2048, 5120)


def phase_sass_against(other: Path, card: str) -> None:
    """Every kernel of the other checkout's csrc/flash_attention.cu and
    csrc/rmsnorm.cu (K1's and K2's, built with this checkout's flags) must compile
    to the same SASS here; the kernels this checkout adds, and any whose SASS
    differs, are named. Then K2's gated entries of the
    two checkouts, through this checkout's wrappers, must agree bit for bit in
    bf16 and are timed in turns (other, this, this, other)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as RN
    differ = []
    for name in ("flash_attention", "rmsnorm"):
        lib, _ = build_other(other, name)
        theirs = sass_functions(_build.BUILD_DIR / f"other-{name}.so")
        mine = sass_functions(_build.library_path(name))
        changed = [n for n in theirs if mine.get(n) != theirs[n]]
        added = sorted(n for n in mine if n not in theirs)
        print(f"sass-against {name}: {len(theirs) - len(changed)} of {len(theirs)} kernels "
              f"of the other checkout SASS-identical here "
              f"({sum(len(t.splitlines()) for t in theirs.values())} lines); {len(added)} "
              f"added: {', '.join(added)}; {len(changed)} differ: {', '.join(changed)}")
        differ += changed
    check(not differ, f"sass-against: SASS differs or is missing for {differ}")

    mine = RN._lib()
    for fn in ("gated_rmsnorm_fwd", "gated_rmsnorm_bwd"):
        getattr(lib, fn).argtypes = getattr(mine, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf16 = torch.bfloat16
    fwd_shape, bwd_shape = GATED_TURNS
    y, z = randn(fwd_shape, bf16, gen), randn(fwd_shape, bf16, gen)
    yb, zb, dout = (randn(bwd_shape, bf16, gen) for _ in range(3))
    sc = randn(fwd_shape[-1:], bf16, gen)
    calls = {f"gated_rmsnorm {fwd_shape}": lambda: RN.gated_rmsnorm_cuda(y, z, sc),
             f"gated_rmsnorm_bwd {bwd_shape}": lambda: RN.gated_rmsnorm_bwd_cuda(yb, zb, sc, dout)}
    for tag, call in calls.items():
        ours = call()
        with swapped(RN, "_lib", lambda: lib):
            theirs = call()
            t_other = time_ms(call)
        t_this = [time_ms(call), time_ms(call)]
        with swapped(RN, "_lib", lambda: lib):
            t_other2 = time_ms(call)
        ours, theirs = (t if isinstance(t, tuple) else (t,) for t in (ours, theirs))
        check(all(torch.equal(a, b) for a, b in zip(ours, theirs)),
              f"sass-against {tag} bf16: the two checkouts' outputs differ")
        print(f"sass-against {tag} bf16, outputs bit-equal; in turns: other {t_other:.4f} ms, "
              f"this {t_this[0]:.4f} ms, this {t_this[1]:.4f} ms, other {t_other2:.4f} ms "
              f"[{card}]")


@contextlib.contextmanager
def swapped(module, name: str, value):
    """``module.name`` set to ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def phase_k1_bwd_against(parent: Path, card: str) -> None:
    """K1's backward of this checkout against the one of another checkout, in one
    process on this card, through the same C entry point. Over the check sweep,
    f32 results must be bit-equal (one f32 design in both) and both bf16 results
    must hold the plain version's gate; where the other has head dim 256, both
    bf16 results must hold it at GEMMA_BWD's shapes too. Then the bf16 backward of
    each is timed in turns (other, this, this, other) at FLASH_BWD_TIMED's shapes
    and, at head dim 256, at GEMMA_BWD's."""
    from repro_torch.kernels import flash_attention as FA
    f32, bf16 = torch.float32, torch.bfloat16
    lib, kernels = build_other(parent, "flash_attention")
    print("k1-bwd-against: the other checkout's K1 bf16 kernels, registers: "
          + ", ".join(gated_registers(kernels, strict=False)))
    other_fn = lib.flash_attention_bwd
    other_fn.argtypes, other_fn.restype = FA._bwd_fn().argtypes, ctypes.c_int

    def other(q, k, v, o, lse, do, causal=True, window=0, probe=False):
        """dq, dk, dv of the other checkout; with ``probe``, its error code."""
        B, Sq, H, D = q.shape
        Skv, K = k.shape[1], k.shape[2]
        delta = torch.empty((B, H, Sq), dtype=f32, device=q.device)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        err = other_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), B, Sq, Skv, H, K, D, int(causal), int(window),
                       1.0 / math.sqrt(D), FA._DTYPE_CODE[q.dtype],
                       torch.cuda.current_stream().cuda_stream)
        if probe:
            return err
        check(err == 0, f"the other checkout's flash_attention_bwd: cudaError {err}")
        return dq, dk, dv

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bf16_equal = 0
    for B, Sq, Skv, H, K, D, causal, window in FLASH_BWD_SWEEP:
        for dtype in (f32, bf16):
            tag = f"{B, Sq, Skv, H, K, D, causal, window} {dtype}"
            q, k, v, do = flash_bwd_inputs(gen, B, Sq, Skv, H, K, D, dtype)
            o, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             return_lse=True)
            mine = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                               window=window)
            theirs = other(q, k, v, o, lse, do, causal=causal, window=window)
            if dtype == f32:
                check(all(torch.equal(a, b) for a, b in zip(mine, theirs)),
                      f"k1-bwd-against {tag}: f32 results differ between the checkouts")
                continue
            bf16_equal += all(torch.equal(a, b) for a, b in zip(mine, theirs))
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                window=window)
            for who, got in (("this", mine), ("other", theirs)):
                for g, w in zip(got, want):
                    check(close(g, w, FLASH_GRAD_TOL[bf16]), f"k1-bwd-against {tag} {who}: "
                          f"max err {max_err(g, w)}")
    print(f"k1-bwd-against: {len(FLASH_BWD_SWEEP)} cases: f32 bit-equal across the two "
          f"checkouts; bf16 of both within the plain version's gate, bit-equal in "
          f"{bf16_equal} of {len(FLASH_BWD_SWEEP)}")
    timed = [(B, S, 128, 0) for B, S in FLASH_BWD_TIMED]
    # head dim 256, where the other checkout has it: bf16 of both within the gate at
    # gemma3-12b's training shapes, then timed there too
    q, k, v, do = flash_bwd_inputs(gen, 1, 64, 64, 2, 1, 256, bf16)
    o, lse = FA.flash_attention_cuda(q, k, v, return_lse=True)
    # a head dim the other's switch does not build returns cudaErrorInvalidValue (1),
    # on valid arguments; any other error fails
    err = other(q, k, v, o, lse, do, probe=True)
    torch.cuda.synchronize()
    check(err in (0, 1), f"the other checkout's flash_attention_bwd at head dim 256: "
          f"cudaError {err}")
    has_256 = err == 0
    if not has_256:
        print("k1-bwd-against: the other checkout has no backward at head dim 256")
    if has_256:
        for S, window in GEMMA_BWD:
            q, k, v, do = flash_bwd_inputs(gen, 1, S, S, 16, 8, 256, bf16)
            o, lse = FA.flash_attention_cuda(q, k, v, window=window, return_lse=True)
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
            for who, got in (("this", FA.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                                  window=window)),
                             ("other", other(q, k, v, o, lse, do, window=window))):
                for g, w in zip(got, want):
                    check(close(g, w, FLASH_GRAD_TOL[bf16]), f"k1-bwd-against D=256 S={S} "
                          f"window={window} {who}: max err {max_err(g, w)}")
            timed.append((1, S, 256, window))
        print("k1-bwd-against: at head dim 256 bf16 of both within the plain version's gate")
    for B, S, D, window in timed:
        q, k, v, do = flash_bwd_inputs(gen, B, S, S, 16, 8, D, bf16)
        o, lse = FA.flash_attention_cuda(q, k, v, window=window, return_lse=True)
        t = [time_ms(lambda: other(q, k, v, o, lse, do, window=window)),
             time_ms(lambda: FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, window=window)),
             time_ms(lambda: FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, window=window)),
             time_ms(lambda: other(q, k, v, o, lse, do, window=window))]
        print(f"k1-bwd-against B={B} S={S} H=16 K=8 D={D} bf16 causal window={window}, in "
              f"turns: other {t[0]:.4f} ms, this {t[1]:.4f} ms, this {t[2]:.4f} ms, other "
              f"{t[3]:.4f} ms [{card}]")


def phase_k2_bwd_against(parent: Path, card: str) -> None:
    """K2's three backward entry points of this checkout against those of another
    checkout, in one process on this card, through the same C entry points (the
    other called as its own wrapper calls it: one launch, dscale folded through a
    zeroed f64 scratch of tickets and rows, one of its own a width, which each
    launch leaves with its tickets at 0). Over the check sweeps,
    f32 dx (dq, dk) must be bit-equal between the two, and every output of both
    must hold the plain version's gate (f32 against the plain version in f64);
    then each bf16 entry is timed at the training shapes in turns (other, this,
    this, other) and profiled once a design, kernel by kernel."""
    from repro_torch.kernels import rmsnorm as RN
    f32, bf16 = torch.float32, torch.bfloat16
    lib, kernels = build_other(parent, "rmsnorm")
    print("k2-bwd-against: the other checkout's K2 backward kernels, registers: "
          + ", ".join(gated_registers(kernels, strict=False)))
    fns = {}
    for name in K2_BWD_ENTRIES:
        fns[name] = getattr(lib, name)
        fns[name].argtypes, fns[name].restype = getattr(RN._lib(), name).argtypes, ctypes.c_int
    blocks = RN._max_blocks(torch.device("cuda"))
    scratches = {}

    def scratch(W):
        if W not in scratches:
            scratches[W] = torch.zeros(RN._TICKETS + (blocks + math.isqrt(blocks - 1) + 2) * W,
                                       dtype=torch.float64, device="cuda")
        return scratches[W].data_ptr()

    def call(name, *args):
        err = fns[name](*args, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the other checkout's {name}: cudaError {err}")

    def other_norm(x, sc, dy, ds):
        D = x.shape[-1]
        dx, dscale = torch.empty_like(x), torch.empty_like(sc)
        tail = (blocks, x.numel() // D, D, 1e-6, RN._DTYPE_CODE[x.dtype], x.device.index)
        if ds is None:
            call("rmsnorm_bwd", x.data_ptr(), sc.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 dscale.data_ptr(), scratch(D), *tail)
        else:
            call("add_rmsnorm_bwd", x.data_ptr(), sc.data_ptr(), ds.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), dscale.data_ptr(), scratch(D), *tail)
        return dx, dscale

    def other_qk(q, k, qs, ks, pos, theta, dq_out, dk_out):
        B, S, H, hd = q.shape
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(qs),
                torch.empty_like(ks))
        freqs = RN._inv_freq(q.device, hd, float(theta))
        call("qk_norm_rope_bwd", *(t.data_ptr() for t in (q, k, qs, ks, dq_out, dk_out, pos)),
             pos.stride(0), pos.stride(1), freqs.data_ptr(), *(t.data_ptr() for t in outs),
             scratch(2 * hd), blocks, B, S, H, k.shape[2], hd, 1e-6,
             RN._DTYPE_CODE[q.dtype], q.device.index)
        return outs

    # entry -> (this, other, plain, make inputs, sweep, dx outputs)
    entries = {
        "rmsnorm_bwd": (lambda x, sc, dy, ds: RN.rmsnorm_bwd_cuda(x, sc, dy),
                        lambda x, sc, dy, ds: other_norm(x, sc, dy, None),
                        lambda x, sc, dy, ds: RN.rmsnorm_bwd_plain(x, sc, dy),
                        norm_bwd_case, NORM_BWD_SWEEP, 1),
        "add_rmsnorm_bwd": (lambda x, sc, dy, ds: RN.add_rmsnorm_bwd_cuda(x, sc, ds, dy),
                            other_norm,
                            lambda x, sc, dy, ds: RN.add_rmsnorm_bwd_plain(x, sc, ds, dy),
                            norm_bwd_case, NORM_BWD_SWEEP, 1),
        "qk_norm_rope_bwd": (RN.qk_norm_rope_bwd_cuda, other_qk, RN.qk_norm_rope_bwd_plain,
                             qk_bwd_case, QK_BWD_SWEEP, 2),
    }
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    timed = {"rmsnorm_bwd": (4, 2048, 1024), "add_rmsnorm_bwd": (4, 2048, 1024),
             "qk_norm_rope_bwd": (4, 2048, 16, 8, 128)}
    for name, (this, other, plain, make, sweep, n_dx) in entries.items():
        for shape in sweep:
            for dtype in (f32, bf16):
                tag = f"k2-bwd-against {name} {shape} {dtype}"
                args = make(gen, *shape, dtype) if name == "qk_norm_rope_bwd" else \
                    make(gen, shape, dtype)
                mine, theirs = this(*args), other(*args)
                want = plain(*(exact(args) if dtype == f32 else args))
                if dtype == f32:
                    check(all(torch.equal(a, b) for a, b in zip(mine[:n_dx], theirs[:n_dx])),
                          f"{tag}: f32 dx differs between the checkouts")
                for who, got in (("this", mine), ("other", theirs)):
                    for i, (g, w) in enumerate(zip(got, want)):
                        check(close(g, w, RMS_TOL[dtype]), f"{tag} {who} output {i}: max err "
                              f"{max_err(g, w)}")
        print(f"k2-bwd-against {name}: {len(sweep)} shapes: f32 dx bit-equal across the two "
              "checkouts; every output of both within the plain version's gate")
        shape = timed[name]
        args = make(gen, *shape, bf16) if name == "qk_norm_rope_bwd" else make(gen, shape, bf16)
        t = [time_ms(lambda: other(*args)), time_ms(lambda: this(*args)),
             time_ms(lambda: this(*args)), time_ms(lambda: other(*args))]
        print(f"k2-bwd-against {name} {shape} bf16, in turns: other {t[0]:.4f} ms, this "
              f"{t[1]:.4f} ms, this {t[2]:.4f} ms, other {t[3]:.4f} ms [{card}]")
        profile_breakdown(f"k2-bwd-against {name} {shape} bf16, other", lambda: other(*args),
                          top=3)
        profile_breakdown(f"k2-bwd-against {name} {shape} bf16, this", lambda: this(*args),
                          top=3)


def phase_k3_bwd_against(parent: Path, card: str) -> None:
    """K3's backward of this checkout against the one of another checkout, in one
    process on this card, through the same C entry point (the other called as its
    own wrapper calls it, with the scratch of the design before the chunk-parallel
    one: the states, f32 [B, H, ceil(S/64), N, P]; dB and dC rows for each
    (32-column P tile, head); dcum and x.dxs for each P tile). Over
    SSD_BWD_SWEEP, with and without init_state and d(final state), f32 results
    must be bit-equal (one f32 design in both) and both bf16 results must hold
    the gates; then the bf16 backward of each is timed in turns (other, this,
    this, other) at SSD_BWD_MAIN and profiled once a design, kernel by kernel."""
    from repro_torch.kernels import ssd_scan as SS
    f32, bf16 = torch.float32, torch.bfloat16
    lib, kernels = build_other(parent, "ssd_scan")
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    other_fn = lib.ssd_scan_bwd
    other_fn.argtypes, other_fn.restype = [P_] * 18 + [I_] * 5 + [L_] * 6 + [I_, P_], I_

    def other(x, dt, a, bm, cm, h0, dy, dfin):
        B, S, H, P = x.shape
        N = bm.shape[-1]
        dev = x.device
        outs = (torch.empty_like(dy), torch.empty((B, S, H), dtype=f32, device=dev),
                torch.empty((H,), dtype=f32, device=dev),
                torch.empty((B, S, N), dtype=x.dtype, device=dev),
                torch.empty((B, S, N), dtype=x.dtype, device=dev),
                None if h0 is None else torch.empty((B, H, N, P), dtype=f32, device=dev))
        states = torch.empty((B, H, -(-S // 64), N, P), dtype=f32, device=dev)
        part_bc = torch.empty((2, P // 32 * H, B, S, N), dtype=f32, device=dev)
        part_t = torch.empty((2, P // 32, B, S, H), dtype=f32, device=dev)
        ptr = [None if t is None else t.data_ptr() for t in (x, dt, a, bm, cm, h0, dy, dfin)]
        err = other_fn(*ptr, *(None if t is None else t.data_ptr() for t in outs),
                       states.data_ptr(), part_bc[0].data_ptr(), part_bc[1].data_ptr(),
                       part_t.data_ptr(), B, S, H, P, N, x.stride(0), x.stride(1),
                       bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
                       SS._DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the other checkout's ssd_scan_bwd: cudaError {err}")
        return outs

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    worst = {"this": 0.0, "other": 0.0}
    for B, S, H, P, N, chunk in SSD_BWD_SWEEP:
        for dtype in (f32, bf16):
            for with_state in (False, True):
                tag = f"k3-bwd-against {B, S, H, P, N, chunk} {dtype} states={with_state}"
                args = ssd_bwd_case(gen, B, S, H, P, N, dtype, with_state)
                mine = SS.ssd_scan_bwd_cuda(*args, chunk=chunk)
                theirs = other(*args)
                if dtype == f32:
                    check(all((a is None and b is None) or torch.equal(a, b)
                              for a, b in zip(mine, theirs)),
                          f"{tag}: f32 results differ between the checkouts")
                    continue
                want = SS.ssd_scan_bwd_plain(*f64(args), chunk=chunk)
                plain_da = SS.ssd_scan_bwd_plain(*args, chunk=chunk)[2]
                for who, got in (("this", mine), ("other", theirs)):
                    worst[who] = max(worst[who],
                                     ssd_bwd_held(f"{tag} {who}", got, want, plain_da, bf16))
                del mine, theirs, want
    print(f"k3-bwd-against: {len(SSD_BWD_SWEEP)} shapes x with/without init_state and "
          f"d(final state): f32 bit-equal across the two checkouts; bf16 of both within "
          f"the gate (worst share: this {worst['this']:.3g}, other {worst['other']:.3g})")
    B, S, H, P, N, chunk = SSD_BWD_MAIN
    args = ssd_bwd_case(gen, B, S, H, P, N, bf16, False)
    t = [time_ms(lambda: other(*args)), time_ms(lambda: SS.ssd_scan_bwd_cuda(*args, chunk=chunk)),
         time_ms(lambda: SS.ssd_scan_bwd_cuda(*args, chunk=chunk)), time_ms(lambda: other(*args))]
    print(f"k3-bwd-against {SSD_BWD_MAIN} bf16, in turns: other {t[0]:.4f} ms, this "
          f"{t[1]:.4f} ms, this {t[2]:.4f} ms, other {t[3]:.4f} ms [{card}]")
    groups = {"K3 backward": ("ssd_scan_bwd",)}
    profile_breakdown(f"k3-bwd-against {SSD_BWD_MAIN} bf16, other", lambda: other(*args),
                      top=3, groups=groups)
    profile_breakdown(f"k3-bwd-against {SSD_BWD_MAIN} bf16, this",
                      lambda: SS.ssd_scan_bwd_cuda(*args, chunk=chunk), top=3, groups=groups)


# ------------------------------------------------------------------------ the cells
def cell_launches(layers: int, microbatches: int, remat: str) -> dict:
    """K1 and K2 launches of one step of a dense train cell with qk-norm:
    ``dense_per_step`` a microbatch, and under remat "full" or "dots" each forward
    kernel of a remat unit (one layer) once more in the backward: K1 and
    qk_norm_rope a layer, rmsnorm (layer 0's ln1) and add_rmsnorm 2L - 1 (every
    norm but the final one, which is outside the units)."""
    per = dense_per_step(layers)
    if remat != "none":
        per = dict(per, flash_attention=2 * layers, qk_norm_rope=2 * layers, rmsnorm=2,
                   add_rmsnorm=4 * layers - 1)
    return {name: n * microbatches for name, n in per.items()}


def dryrun_train_cut(out: str, core) -> None:
    """The dry-run (``roofline/op_stats.py``) of the train cell at the card's cut,
    remat full, on CPU fake tensors; runs in a process of its own, on one thread
    pinned to ``core`` where one is given (``start_dryrun``), beside the card's
    phases, and writes its record to ``out``."""
    if core is not None:
        os.sched_setaffinity(0, {core})
    torch.set_num_threads(1)
    from repro_torch.launch.steps import CellOptions, build_cell
    from repro_torch.models.params import TensorDef
    from repro_torch.roofline.op_stats import call_stats, stats_to_json
    t0 = time.perf_counter()
    cell = build_cell(CELLS_ARCH, "train_4k", CellOptions(remat="full"), device="cpu")
    state, batch = cell.abstract_args
    cut = {k: TensorDef((CELLS_TRAIN_BATCH,) + d.shape[1:], d.dtype) for k, d in batch.items()}
    rec = stats_to_json(call_stats(cell.fn, (state, cut)))
    rec["seconds"] = time.perf_counter() - t0
    Path(out).write_text(json.dumps(rec))


def start_dryrun():
    """Start ``dryrun_train_cut`` in a spawned process (it touches no card) on the
    last of this process's cores, and leave that core to it: the calling thread,
    and every thread it starts from here on, keeps to the other cores, so that the
    card's phases do not share a core with it. Returns (the process, its output
    path)."""
    import multiprocessing
    out = ROOT / "build" / "dryrun_train_cut.json"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    cores = sorted(os.sched_getaffinity(0))
    core = cores[-1] if len(cores) > 1 else None
    proc = multiprocessing.get_context("spawn").Process(
        target=dryrun_train_cut, args=(str(out), core), daemon=True)
    proc.start()
    if core is not None:
        os.sched_setaffinity(0, set(cores[:-1]))
    print(f"chip_smoke: the dry-run's process on core {core}, this one on {cores[:-1]}")
    return proc, out


def counted(launches: dict, wrappers: dict) -> dict:
    """The wrappers' counts of one run, also added to ``launches``."""
    got = {name: fn.launches for name, fn in wrappers.items()}
    for name, n in got.items():
        launches[name] += n
    return got


def held_launches(tag: str, got: dict, want: dict) -> None:
    for name, n in got.items():
        check(n == want.get(name, 0), f"{tag}: {name} launched {n} times, want "
              f"{want.get(name, 0)}")


def phase_cells_train(card: str, launches: dict) -> dict:
    """train_4k's cell, cut to global batch 8 (M = 8 microbatches of 1 x 4,096), one
    step under each remat mode from the same state (seed 0) and batch: loss,
    grad_norm and the updated params bit-equal across the modes; peak memory
    full < dots < none; every kernel's launches exact. Then a warm step under
    ``full`` timed. Returns {mode: (peak bytes, step ms)} and the warm step's ms."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.steps import CellOptions, build_cell, init_train_state
    from repro_torch.tree import tree_flatten_sorted
    props = torch.cuda.get_device_properties(0)
    print(f"card memory: total_memory {props.total_memory} bytes ({props.name}); "
          f"repro_torch.launch.mesh.HBM_BYTES {HBM_BYTES}")
    if props.name == "NVIDIA H100 80GB HBM3":
        check(props.total_memory == HBM_BYTES, f"HBM_BYTES {HBM_BYTES} != the card's "
              f"{props.total_memory}")
    out, ref = {}, None
    for mode in ("none", "full", "dots"):
        cell = build_cell(CELLS_ARCH, "train_4k", CellOptions(remat=mode))
        M, L = cell.fn.num_microbatches, cell.cfg.num_layers
        check(M == 8 and L == 28 and cell.cfg.remat == mode, f"train cell: M {M}, {L} layers")
        data = SyntheticTokens(vocab_size=cell.cfg.vocab_size, seq_len=cell.spec.seq_len,
                               global_batch=CELLS_TRAIN_BATCH, seed=0, task="random")
        batch = {k: v.cuda() for k, v in data.global_batch_at(0).items()}
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        state = init_train_state(cell.model, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wrappers = reset_launches()
        t0 = time.perf_counter()
        state, met = cell.fn(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = counted(launches, wrappers)
        peak = torch.cuda.max_memory_allocated() - base
        held_launches(f"train cell remat={mode}", got, cell_launches(L, M, mode))
        loss, gnorm = met["loss"].item(), met["grad_norm"].item()
        params = [t for _, t in tree_flatten_sorted(state["params"])]
        print(f"train cell {cell.name} remat={mode}: {CELLS_TRAIN_BATCH} x "
              f"{cell.spec.seq_len} tokens in {M} microbatches, loss {loss!r}, grad_norm "
              f"{gnorm!r}, first step {ms:.1f} ms, peak {peak / 2**30:.2f} GiB above the "
              f"{base / 2**30:.2f} GiB before its state [{card}]; launches {got}")
        check(math.isfinite(loss) and math.isfinite(gnorm), f"train cell {mode}: {met}")
        if ref is None:
            ref = (loss, gnorm, params)
        else:
            check(loss == ref[0] and gnorm == ref[1], f"train cell remat={mode}: loss "
                  f"{loss!r} grad_norm {gnorm!r} != none's {ref[0]!r} {ref[1]!r}")
            check(all(torch.equal(a, b) for a, b in zip(params, ref[2])),
                  f"train cell remat={mode}: params after the step differ from none's")
        warm_ms = None
        if mode == "full":             # a warm step (from the stepped state) timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cell.fn(state, batch)
            torch.cuda.synchronize()
            warm_ms = (time.perf_counter() - t0) * 1e3
            out["warm_ms"] = warm_ms
        out[mode] = (peak, ms)
        del cell, state, met, params, batch
        gc.collect()
        torch.cuda.empty_cache()
    check(out["full"][0] < out["dots"][0] < out["none"][0],
          f"train cell peaks (full, dots, none) {[out[m][0] for m in ('full', 'dots', 'none')]}"
          f" not increasing")
    tokens = CELLS_TRAIN_BATCH * 4096
    print(f"train cell: loss, grad_norm and params bit-equal under none, full and dots; peak "
          f"GiB full {out['full'][0] / 2**30:.2f} < dots {out['dots'][0] / 2**30:.2f} < none "
          f"{out['none'][0] / 2**30:.2f}; warm full step {out['warm_ms']:.1f} ms = "
          f"{tokens / out['warm_ms'] * 1e3:.0f} tokens/s [{card}]")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def prefill_vs_forward(cfg, params: dict, toks, S: int):
    """(the prefill cell's last logits, forward's at the last position) of
    ``toks`` on a model of ``cfg``; forward's as its final-normed hidden state at
    the last position times the unembedding, without the [B, S, V] logits."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model
    model = Model(cfg, "cuda")
    last, cache = make_prefill_step(model, S)(params, {"tokens": toks})
    del cache
    with torch.no_grad():
        hidden, _ = model.forward(params, {"tokens": toks}, return_hidden=True)
        want = hidden[:, -1] @ model._table(params)
    return last, want


def k1_at_32k(out, want, tag: str) -> float:
    """K1's output at S = 32,768 held against its plain version at TOL and, with the
    values' RMS as the unit of the absolute term, at RMS_UNIT_TOL; the magnitudes of
    the plain output printed beside the errors. Returns the max abs error."""
    err, ratio = max_err(out, want), rms_tol(out, want)
    w = want.float().abs()
    dtype = want.dtype
    print(f"flash S={want.shape[1]} {tag}: max abs err {err:.4g}, rms_tol {ratio:.3g} (gates "
          f"{TOL[dtype]} and {RMS_UNIT_TOL[dtype, 'fwd']}); |plain output| median "
          f"{w.median().item():.4g}, max {w.max().item():.4g}, RMS "
          f"{w.square().mean().sqrt().item():.4g}; the last row's median "
          f"{w[:, -1].median().item():.4g}")
    check(close(out, want, TOL[dtype]) and ratio <= RMS_UNIT_TOL[dtype, "fwd"],
          f"flash S={want.shape[1]} {tag}: max err {err}, rms_tol {ratio:.3g}")
    return err


def phase_cells_serve(card: str, launches: dict, k1_row: dict) -> None:
    """prefill_32k's cell at B = 1 (one 32,768-token prompt) and decode_32k's at
    B = 4, the launches exact. K1 on the prompt's layer-0 q, k and v against its
    plain version (``k1_at_32k``: bf16, and f32 with a negative control) and timed
    beside its bound and SDPA (cuDNN); the cell's logits against forward's last
    position, a wiring check (the same kernels and ops a row; f32 at every layer
    1e-4, bf16 at 4 layers 0.08, bf16 at 28 printed); the decode cell's 16 teacher-forced steps over
    the prompt's last 16 positions, its tokens/s, and the same run in f32 at 4 layers
    against the prefill of the whole prompt (1e-4)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import build_cell, make_decode_step, make_prefill_step
    from repro_torch.models import layers as LY
    from repro_torch.models.model import Model, _unstack
    from repro_torch.tree import tree_leaves, tree_map

    cell = build_cell(CELLS_ARCH, "prefill_32k")
    cfg, S, L = cell.cfg, cell.spec.seq_len, cell.cfg.num_layers
    params = cell.model.init_params(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (CELLS_PREFILL_BATCH, S), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    wrappers = reset_launches()
    t0 = time.perf_counter()
    last, cache = cell.fn(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    got = counted(launches, wrappers)
    held_launches("prefill cell", got, {k: v[0] for k, v in PATHS[0]["launches"].items()})
    check(tuple(last.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(last).all()),
          f"prefill cell: logits {tuple(last.shape)}")
    print(f"prefill cell {cell.name}: 1 x {S} tokens in {prefill_s * 1e3:.1f} ms (first "
          f"call) = {S / prefill_s:.0f} tokens/s [{card}]; launches {got}")

    # K1 at Sq = Skv = 32,768 on the prompt's layer-0 q, k, v
    with torch.no_grad():
        p0 = _unstack(params["layers"])[0]
        h = LY.rmsnorm(params["embed"][toks], p0["ln1"], cfg.norm_eps)
        q, k, v = (t.contiguous() for t in LY.qkv_project(
            p0["attn"], h, positions=cell.model._positions(1, S), theta=cfg.rope_theta,
            eps=cfg.norm_eps))
        del h
    out = FA.flash_attention_cuda(q, k, v)
    want = FA.flash_attention_plain(q, k, v)
    err = k1_at_32k(out, want, "bf16")
    del out
    q32, k32, v32 = (t.float() for t in (q, k, v))
    out32 = FA.flash_attention_cuda(q32, k32, v32)
    want32 = FA.flash_attention_plain(q32, k32, v32)
    err32 = k1_at_32k(out32, want32, "f32")
    dropped = v32.clone()
    dropped[:, -CELLS_K1_DROP:] = 0
    wrong = FA.flash_attention_plain(q32, k32, dropped)
    wrong_abs, wrong_rms = max_err(wrong, want32), rms_tol(wrong, want32)
    check(not close(wrong, want32, TOL[torch.float32])
          and wrong_rms > RMS_UNIT_TOL[torch.float32, "fwd"],
          f"flash S={S}: the f32 gates pass an output without the last {CELLS_K1_DROP} "
          f"keys' values (max err {wrong_abs}, rms_tol {wrong_rms:.3g})")
    print(f"flash S={S} f32: the plain output with the last {CELLS_K1_DROP} keys' values "
          f"zeroed fails both gates (max err {wrong_abs:.3g}, rms_tol {wrong_rms:.3g})")
    del q32, k32, v32, out32, want32, dropped, wrong
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    backend = sdpa_backend(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    check(close(lib.transpose(1, 2), want, TOL[torch.bfloat16]), "SDPA disagrees at 32k")
    del lib
    ms = time_ms(lambda: FA.flash_attention_cuda(q, k, v), n=10)
    plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v), n=3)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), n=10)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * q.shape[2] * q.shape[3] * attn_pairs(S, S, True, 0)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[torch.bfloat16])
    k1_row["prefill_32k"] = {"B": 1, "S": S, "H": q.shape[2], "K": k.shape[2],
                             "launches": got["flash_attention"], "max_abs_err": err,
                             "max_abs_err_f32": err32, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": lib_ms,
                             "library_backend": backend}
    print(f"flash_attention B=1 S={S} H=16 K=8 D=128 bf16 causal (the prefill cell's layer "
          f"0): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({backend}),"
          f" bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e12:.3f} TFLOP, "
          f"{nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} TFLOP/s, max abs err {err:.3g} "
          f"[{card}]")
    del q, k, v, qt, kt, vt, want
    gc.collect()
    torch.cuda.empty_cache()

    # the prefill cell's logits against forward's last position
    f32 = dataclasses.replace(cfg, dtype="float32")
    cases = [(f"f32, {L} layers", f32, lambda: tree_map(lambda t: t.float(), params), 1e-4),
             ("bf16, 4 layers", dataclasses.replace(cfg, num_layers=4),
              lambda: dict(params, layers=tree_map(lambda t: t[:4], params["layers"])), 0.08),
             (f"bf16, {L} layers", cfg, lambda: params, None)]
    for tag, case_cfg, make, tol in cases:
        case_params = make()
        got_last, want_last = prefill_vs_forward(case_cfg, case_params, toks, S)
        err = max_err(got_last, want_last)
        print(f"prefill cell vs forward's last position (a wiring check; {tag}, 1 x {S} "
              f"tokens): max abs err "
              f"{err:.4g}, |logit| max {want_last.float().abs().max().item():.3g}")
        check(bool(torch.isfinite(got_last).all()), f"prefill cell ({tag}): non-finite")
        if tol is not None:
            check(close(got_last, want_last, tol), f"prefill cell vs forward ({tag}): max "
                  f"err {err} > {tol}")
        del case_params, got_last, want_last
        gc.collect()
        torch.cuda.empty_cache()

    # decode_32k at B = 4: the prefill cell's cache, the last 16 positions again
    dcell = build_cell(CELLS_ARCH, "decode_32k")
    B, n = CELLS_DECODE_BATCH, CELLS_DECODE_STEPS
    cache_bytes = sum(math.prod(d.shape) * d.dtype.itemsize
                      for d in tree_leaves(dcell.model.abstract_cache(B, S)))
    check(cache_bytes == CELLS_DECODE_CACHE_BYTES, f"decode cell: cache {cache_bytes} bytes")
    dcache = dcell.model.init_cache(B, S)
    for j, kv in enumerate(dcache["layers"]):
        for name in ("k", "v"):
            kv[name].copy_(cache["layers"][j][name])          # the one row to all B
    dcache["pos"].fill_(S - n)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    wrappers = reset_launches()
    t0 = time.perf_counter()
    for i in range(n):
        logits, dcache = dcell.fn(params, toks[:, S - n + i:S - n + i + 1].expand(B, 1),
                                  dcache)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    got = counted(launches, wrappers)
    held_launches("decode cell", got, {k: v[1] * n for k, v in PATHS[0]["launches"].items()})
    check(int(dcache["pos"][0]) == S and bool(torch.isfinite(logits).all())
          and all(close(logits[b], logits[0], 2e-2) for b in range(B)),
          f"decode cell: pos {dcache['pos'].tolist()}, rows of one context disagree")
    print(f"decode cell {dcell.name}: B = {B}, a {cache_bytes / 1e9:.2f} GB cache of {S} "
          f"positions, {n} steps in {decode_s * 1e3:.1f} ms = {B * n / decode_s:.1f} tokens/s "
          f"[{card}]; the last step (position {S - 1}) against the prefill cell's last logits "
          f"(bf16, {L} layers): max abs err {max_err(logits[0], last[0]):.4g}; launches {got}")
    del dcache, logits
    gc.collect()
    torch.cuda.empty_cache()

    # the same decode run in f32 at 4 layers, against the prefill of the whole prompt
    cfg4 = dataclasses.replace(cfg, dtype="float32", num_layers=4)
    p4 = tree_map(lambda t: t.float(), dict(params, layers=tree_map(lambda t: t[:4],
                                                                     params["layers"])))
    model4 = Model(cfg4, "cuda")
    want4, _ = make_prefill_step(model4, S)(p4, {"tokens": toks})
    _, c4 = make_prefill_step(model4, S)(p4, {"tokens": toks[:, :S - n]})
    step4 = make_decode_step(model4)
    for i in range(n):
        got4, c4 = step4(p4, toks[:, S - n + i:S - n + i + 1], c4)
    err = max_err(got4, want4)
    print(f"decode cell, f32 at 4 layers: prefill of {S - n} tokens + {n} decode steps vs the "
          f"prefill of all {S}: max abs err {err:.4g}")
    check(close(got4, want4, 1e-4), f"decode cell f32 4 layers: max err {err}")
    del p4, c4, want4, got4, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_long_context(card: str) -> dict:
    """mamba2-2.7b's long_500k cell (B = 1): its state from a prefill of the first
    32,752 of 32,768 tokens, then 16 decode steps at positions 524,272-524,287,
    teacher-forced with the prompt's last 16 tokens, every kernel's launches exact;
    the state's bytes the same as at a 32,768-token context; the last step's logits
    against the prefill of all 32,768 tokens, printed; then the same run in f32 at
    LONG_F32_LAYERS layers against the prefill, at LONG_F32_TOL. Returns the
    launches."""
    from repro_torch.launch.steps import build_cell, make_decode_step, make_prefill_step
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves, tree_map
    launches = dict.fromkeys(kernel_wrappers(), 0)
    cell = build_cell(LONG_ARCH, "long_500k")
    spec, cfg = cell.spec, cell.cfg
    check(spec.seq_len == 524_288 and spec.global_batch == 1 and cfg.num_layers == 64,
          f"long_500k cell: {spec}")
    state_bytes = [sum(math.prod(d.shape) * d.dtype.itemsize
                       for d in tree_leaves(cell.model.abstract_cache(1, n)))
                   for n in (spec.seq_len, LONG_PREFILL)]
    check(state_bytes[0] == state_bytes[1], f"long_500k: state bytes {state_bytes}")
    params = cell.model.init_params(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_PREFILL), generator=gen, device="cuda")
    n = CELLS_DECODE_STEPS
    prefill = make_prefill_step(cell.model, LONG_PREFILL)
    want, _ = prefill(params, {"tokens": toks})
    _, cache = prefill(params, {"tokens": toks[:, :-n]})
    cache["pos"].fill_(spec.seq_len - n)
    torch.cuda.synchronize()
    wrappers = reset_launches()
    t0 = time.perf_counter()
    for i in range(n):
        at = LONG_PREFILL - n + i
        logits, cache = cell.fn(params, toks[:, at:at + 1], cache)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counted(launches, wrappers)
    held_launches("long_500k cell", got,
                  {k: v[1] * n for k, v in PATHS[1]["launches"].items()})
    check(int(cache["pos"][0]) == spec.seq_len and bool(torch.isfinite(logits).all()),
          f"long_500k: pos {cache['pos'].tolist()}")
    print(f"long_500k cell {cell.name}: a state of {state_bytes[0] / 1e6:.2f} MB at any "
          f"context, {n} decode steps at positions {spec.seq_len - n}-{spec.seq_len - 1} in "
          f"{dt * 1e3:.1f} ms = {n / dt:.1f} tokens/s [{card}]; the last step against the "
          f"prefill of all {LONG_PREFILL} tokens (bf16, 64 layers): max abs err "
          f"{max_err(logits, want):.4g}; launches {got}")
    del cache, logits, want
    gc.collect()
    torch.cuda.empty_cache()

    # the same decode run in f32 at LONG_F32_LAYERS layers, against the prefill
    cfg4 = dataclasses.replace(cfg, dtype="float32", num_layers=LONG_F32_LAYERS)
    p4 = tree_map(lambda t: t.float(), dict(params, layers=tree_map(
        lambda t: t[:LONG_F32_LAYERS], params["layers"])))
    del params
    model4 = Model(cfg4, "cuda")
    prefill4 = make_prefill_step(model4, LONG_PREFILL)
    want4, _ = prefill4(p4, {"tokens": toks})
    _, c4 = prefill4(p4, {"tokens": toks[:, :-n]})
    c4["pos"].fill_(spec.seq_len - n)
    step4 = make_decode_step(model4)
    for i in range(n):
        at = LONG_PREFILL - n + i
        got4, c4 = step4(p4, toks[:, at:at + 1], c4)
    err = max_err(got4, want4)
    print(f"long_500k, f32 at {LONG_F32_LAYERS} layers: prefill of {LONG_PREFILL - n} tokens + "
          f"{n} decode steps at positions {spec.seq_len - n}+ vs the prefill of all "
          f"{LONG_PREFILL}: max abs err {err:.4g}, |logit| max "
          f"{want4.abs().max().item():.3g}")
    check(close(got4, want4, LONG_F32_TOL), f"long_500k f32 {LONG_F32_LAYERS} layers: max "
          f"err {err}")
    del p4, c4, want4, got4
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_titchener_cell(card: str, launches: dict) -> None:
    """train_4k's Titchener cell: one local-SGD round (H = 8 inner steps of 1 x 4,096
    tokens, one pod, remat full as the config's), the launches exact, the pod's
    params the master's after the round."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.steps import CellOptions, build_cell
    from repro_torch.optim.local_sgd import init_local_sgd_state
    cell = build_cell(CELLS_ARCH, "train_4k", CellOptions(titchener=True))
    state_abs, batches_abs = cell.abstract_args
    H, P, Bp, S = batches_abs["tokens"].shape
    check((H, P, Bp) == (8, 1, 32), f"titchener cell: batches {batches_abs['tokens'].shape}")
    Bp = CELLS_TRAIN_BATCH // (H * P)
    state = init_local_sgd_state(cell.model.init_params(0), P)
    data = SyntheticTokens(vocab_size=cell.cfg.vocab_size, seq_len=S,
                           global_batch=CELLS_TRAIN_BATCH, seed=1, task="random")
    batches = {k: v.reshape(H, P, Bp, S).cuda() for k, v in data.global_batch_at(0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = reset_launches()
    t0 = time.perf_counter()
    state, met = cell.fn(state, batches)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = counted(launches, wrappers)
    held_launches("titchener cell", got, cell_launches(cell.cfg.num_layers, H, cell.cfg.remat))
    delta = met["delta_norm"].item()
    check(math.isfinite(delta) and delta > 0 and int(state["round"]) == 1
          and pods_synced(state), f"titchener cell: delta_norm {delta}, round "
          f"{int(state['round'])}")
    print(f"titchener cell {cell.name}: one round of H = {H} x {Bp} x {S} tokens (one pod, "
          f"remat {cell.cfg.remat}) in {ms:.1f} ms (first call) = "
          f"{H * Bp * S / ms * 1e3:.0f} tokens/s, delta_norm {delta:.4g}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]; launches {got}")
    del state, batches, cell
    gc.collect()
    torch.cuda.empty_cache()


def phase_dryrun_vs_card(card: str, dryrun, train: dict) -> None:
    """The dry-run's prediction of the train cell (remat full, the card's cut)
    beside the card: its peak_bytes within DRYRUN_PEAK_RTOL of the card's peak
    above the memory in use before the step's state; its flops over the warm step's
    ms as a share of PEAK_FLOPS_BF16."""
    proc, out = dryrun
    t0 = time.perf_counter()
    proc.join(timeout=600)
    waited = time.perf_counter() - t0
    check(proc.exitcode == 0 and out.exists(), f"dry-run process: exit {proc.exitcode}")
    rec = json.loads(out.read_text())
    card_peak, warm_ms = train["full"][0], train["warm_ms"]
    rel = rec["peak_bytes"] / card_peak - 1
    share = rec["flops"] / (warm_ms / 1e3) / PEAK_FLOPS_BF16
    print(f"dry-run of the train cell (remat full, {CELLS_TRAIN_BATCH} x 4096 tokens, fake "
          f"tensors on the CPU, {rec['seconds']:.1f} s, {rec['ops']} ops; waited "
          f"{waited:.1f} s): predicted peak {rec['peak_bytes'] / 2**30:.3f} GiB, the card's "
          f"{card_peak / 2**30:.3f} GiB ({rel:+.3f}); flops {rec['flops']:.4e} over the warm "
          f"step's {warm_ms:.1f} ms = {share:.3f} of the bf16 peak (every dot product of "
          f"the plain path, K1's masked blocks too: {rec['dot_flops']:.4e}); framework bytes "
          f"{rec['framework_bytes']:.4e}, kernel-internal {rec['kernel_bytes']:.4e} [{card}]")
    check(abs(rel) <= DRYRUN_PEAK_RTOL, f"dry-run peak {rec['peak_bytes']} vs the card's "
          f"{card_peak}: {rel:+.3f} beyond {DRYRUN_PEAK_RTOL}")


def phase_train_100m(card: str) -> dict:
    """``examples/torch_train_100m.py --steps 300`` on the card, to its own assert
    (final loss < ln(1024) - 2), every kernel's launches exact (remat none, one
    microbatch of 8 x 128 tokens a step). Returns the launches."""
    wrappers = reset_launches()
    t0 = time.perf_counter()
    losses = load_example("torch_train_100m").main(["--steps", str(TRAIN_100M_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    held_launches("torch_train_100m", launches, cell_launches(12, TRAIN_100M_STEPS, "none"))
    check(len(losses) == TRAIN_100M_STEPS and losses[-1] < math.log(1024) - 2,
          f"torch_train_100m: final loss {losses[-1]}")
    print(f"torch_train_100m: {TRAIN_100M_STEPS} steps of 8 x 128 tokens in {wall:.2f} s "
          f"(model build included) = {TRAIN_100M_STEPS * 8 * 128 / wall:.0f} tokens/s, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} [{card}]; launches {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_cells(card: str, dryrun, k1_row: dict) -> dict:
    """The cells, the dry-run beside the card and the 100M example; returns each
    kernel's launches by path."""
    cells = dict.fromkeys(kernel_wrappers(), 0)
    train = phase_cells_train(card, cells)
    phase_cells_serve(card, cells, k1_row)
    phase_titchener_cell(card, cells)
    phase_dryrun_vs_card(card, dryrun, train)
    return {CELLS_PATH: cells, LONG_PATH: phase_long_context(card),
            TRAIN_100M_PATH: phase_train_100m(card)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1-bwd-against", type=Path, metavar="CHECKOUT",
                    help="only build the kernels and compare K1's backward with the one "
                         "of another checkout (its root directory), in turns on this card")
    ap.add_argument("--k2-bwd-against", type=Path, metavar="CHECKOUT",
                    help="only build the kernels and compare K2's backward with the one "
                         "of another checkout (its root directory), in turns on this card")
    ap.add_argument("--k3-bwd-against", type=Path, metavar="CHECKOUT",
                    help="only build the kernels and compare K3's backward with the one "
                         "of another checkout (its root directory), in turns on this card")
    ap.add_argument("--sass-against", type=Path, metavar="CHECKOUT",
                    help="only build the kernels and check that every K1 and K2 kernel of "
                         "another checkout compiles to the same SASS here")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_card()
    phase_build()
    against = {"k1_bwd_against": phase_k1_bwd_against, "k2_bwd_against": phase_k2_bwd_against,
               "k3_bwd_against": phase_k3_bwd_against, "sass_against": phase_sass_against}
    chosen = {k: getattr(args, k) for k in against}
    if any(v is not None for v in chosen.values()):
        for k, checkout in chosen.items():
            if checkout is not None:
                against[k](checkout, card)
        print(card)
        return 0
    dryrun = start_dryrun()          # CPU only, on a core of its own
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def mark(phase: str) -> None:
        print(f"chip_smoke: {phase} at {time.perf_counter() - t_start:.1f} s")

    rows = [phase_flash(gen), *phase_rmsnorm(gen), phase_ssd(gen), *phase_backward(gen),
            *phase_ssm_backward(gen)]
    encdec_fwd, encdec_bwd = phase_flash_encdec(gen)
    rows[0]["encdec_vlm"] = encdec_fwd
    next(r for r in rows if r["name"] == "flash_attention_bwd")["encdec_vlm"] = encdec_bwd
    mark("kernel phases done")
    phase_train_step_parity("qwen3-0.6b", 256, TRAIN_PER_STEP)
    # 300 tokens: ragged for the kernel's 64-row chunks and the model's 256
    phase_train_step_parity("mamba2-2.7b", 300, SSM_TRAIN_PER_STEP)
    phase_train_step_parity("gemma3-12b", GEMMA_PARITY_SEQ, GEMMA_TRAIN_PER_STEP,
                            batch_size=1, cut=GEMMA_PARITY)
    phase_train_step_parity("zamba2-7b", ZAMBA_PARITY_SEQ,
                            hybrid_per_step(ZAMBA_PARITY["num_layers"], 6), batch_size=1,
                            cut=ZAMBA_PARITY)
    phase_train_step_parity("deepseek-moe-16b", MOE_PARITY_SEQ, MOE_TRAIN_PER_STEP,
                            batch_size=1, cut=MOE_PARITY)
    phase_train_step_parity("whisper-medium", WHISPER_PARITY_SEQ,
                            encdec_per_step(2, 2), batch_size=1, cut=WHISPER_PARITY)
    phase_train_step_parity("llama-3.2-vision-90b", LLAMA_PARITY_SEQ,
                            vlm_per_step(LLAMA_PARITY["num_layers"]), batch_size=1,
                            cut=LLAMA_PARITY)
    phase_local_sgd_parity()
    gc.collect()
    torch.cuda.empty_cache()
    mark("train-step parity done")
    by_path = {}
    for path in PATHS:
        with (arch_depth(path["arch"], path["layers"]) if "layers" in path
              else contextlib.nullcontext()):
            by_path[path["arch"]] = phase_serve(card, path)
        gc.collect()                   # release this server before the next one
        torch.cuda.empty_cache()
        mark(f"serve {path['arch']} done")
    by_path[TRAIN_PATH] = phase_train(card)
    by_path[PLANE_PATH] = phase_local_plane(card)
    mark("plane done")
    by_path[LAUNCH_PATH] = phase_launchers(card)
    mark("launchers done")
    by_path[PHI4_LAUNCH_PATH] = phase_phi4(card)
    mark("phi4-mini-3.8b done")
    by_path[SSM_TRAIN_PATH] = phase_ssm_train(card)
    phase_ssm_tasks()
    mark("qwen3 and mamba2 training done")
    for path in CUT_TRAINS:
        by_path[path] = phase_cut_train(card, path)
        mark(f"{path} done")
    phase_encdec_task()
    mark("whisper-medium task done")
    by_path[LOCAL_SGD_PATH] = phase_local_sgd_train(card)
    phase_local_sgd_task()
    mark("local SGD done")
    by_path.update(phase_cells(card, dryrun, rows[0]))
    mark("cells, dry-run and the 100M example done")
    for row in rows:
        # each kernel's launches in the serve and train tasks of the paths that run it
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()
                                   if n[row["name"]]}
        row["launches"] = sum(row["launches_by_path"].values())
        check(row["launches"] > 0, f"{row['name']} was never launched on a main path")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
