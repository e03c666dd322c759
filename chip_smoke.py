#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs one card
    python3 chip_smoke.py --k1-bwd-against DIR   # only K1's backward against DIR's
    python3 chip_smoke.py --k2-bwd-against DIR   # only K2's backward against DIR's
    python3 chip_smoke.py --k3-bwd-against DIR   # only K3's backward against DIR's
    python3 chip_smoke.py --sass-against DIR     # only K1's, K2's and K3's SASS against DIR's

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
     qk_norm_rope, one launch each with dscale folded in; gated_rmsnorm's, a row
     pass and a fold, with K3's in the ssm phase) against their plain
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
     shape (no library call for either); then K2's gated norm over a split row
     (``phase_split_norm``: its four entries, gated_rmsnorm_stats,
     gated_rmsnorm_split, gated_rmsnorm_split_dot and gated_rmsnorm_split_bwd, at
     d_inner 5,120 and 7,168 split 2, 4 and 8 ways, the row sums added in place
     of the all-reduce, against their plain versions and, put back together,
     against the whole-row kernel, both ways; timed beside their byte bounds,
     with the L2 flushed before each call and warm);
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
     (``phase_elastic``) the same 4 steps with the state re-meshed after step 2
     onto a one-rank NCCL ``DeviceMesh`` and back (``runtime/elastic.py``), twice,
     each ``remesh_state`` timed: losses and state bit-equal to an uninterrupted
     run, launches exact; the sharded forward (DTensor params, a 4 x 512 batch) on
     that mesh bit-equal to the one-device forward, launches exact; an
     ``ElasticController`` on a management plane of ``TorchLocalPlane``s seeing a
     lost cluster leave and a new one join (the path "qwen3-0.6b elastic"); then
     (``phase_tensor_parallel``) the tensor-parallel code on a one-rank NCCL
     ("data", "model") mesh: a Trainer there (its state DTensors) for 3 steps of
     TRAIN's tokens, losses, grad norms and every state tensor bit-equal to the
     one-device Trainer's, K1 and K2 launched exactly 3 steps'; its state saved
     from that mesh restores bit-equal on one device; a Server there serves the
     serve path's requests with the one-device Server's greedy tokens, launches
     exact (the path "qwen3-0.6b tensor-parallel"); then
     (``phase_ssm_tensor_parallel``) the ssm and hybrid families' tensor-parallel
     code: on a one-rank NCCL mesh mamba2-2.7b (4 layers) and zamba2-7b (7)
     Trainers, 2 steps of 2,048 tokens, and a full-depth mamba2-2.7b Server,
     bit-equal to one device, launches exact (the paths "mamba2-2.7b
     tensor-parallel", "zamba2-7b tensor-parallel"); then two gloo ranks spawned
     on the one card as a (1, 2) mesh, where the mamba2 layers split d_inner and
     the heads and the gated norm runs through K2's split-row entries: the same
     Trainers and a short serve within the bf16 gates of one device, every
     kernel's launches exact on both ranks (the paths "... (1, 2) ranks"); then
     (``phase_xattn_tensor_parallel``) the encdec and vlm families' the same two
     ways: a whisper-medium Trainer at 4 + 4 layers (2 steps of 2,048 tokens over
     its 1,500 frames) and teacher-forced prefill and decode steps of whisper
     (full depth in bf16 and f32, 4 decoder layers in bf16) and
     llama-3.2-vision-90b (5 layers) on random frames and patches, gates at 0.5,
     bit-equal to one device on the one-rank mesh, on the two gloo ranks within
     0.02 (losses), 0.08 (bf16 logits; whisper's at full depth printed) and 1e-4
     (f32 logits), launches exact (the paths "whisper-medium tensor-parallel",
     "llama-3.2-vision-90b tensor-parallel", "... (1, 2) ranks"); then
     (``phase_moe_tensor_parallel``) the moe family's expert parallelism the same
     two ways: a deepseek-moe-16b Trainer at 2 layers (2 steps of 2,048 tokens,
     capacity 1.25) and teacher-forced prefill and decode steps of deepseek-moe at
     4 layers and qwen3-moe-235b-a22b at 2, bit-equal to one device on the
     one-rank mesh (the Trainer with PyTorch's deterministic algorithms on, beside
     the spread of a one-device run with them off); on the two gloo ranks, each
     holding half the experts, losses within 5e-3, grad norms within 0.02 and
     bf16 logits within 0.08, launches exact (the paths "deepseek-moe-16b
     expert-parallel", "qwen3-moe-235b-a22b expert-parallel", "... (1, 2)
     ranks"); then
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
     ``examples/torch_hybrid_pipeline.py`` (at full width, cut to
     EXAMPLE_LAYERS); then (``phase_phi4``) phi4-mini-3.8b
     through the serve launcher's direct mode at full width and depth, the
     counters exact (the path "phi4-mini-3.8b launcher"), and its prefill + one
     decode step against forward (f32 at every layer, bf16 at 4);
  8. train mamba2-2.7b at full width and depth, bf16, through ``run_train_task``
     (2 steps of 2048 tokens), the counters read around it (every K2 and K3
     entry of the path, exactly so many a layer a step); time warm steps and
     profile one (K3's backward kernels, each at the training shape, by launch);
     then its train task (4 steps, a checkpoint every 2) and a
     strict eval-task restore at full width and SSM_TASK_LAYERS (a 64-layer save
     is ~39.6 GB);
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
     step each way, at head dim 64), and its checkpointed task at 4 encoder and
     4 decoder layers (2 steps, a checkpoint every 2) and a strict eval-task
     restore;
 10. train qwen3-0.6b at full width and depth in local_sgd mode (the Titchener
     mode: 2 pods, H = 4 inner steps a round, 2 x 2048 tokens a pod, bf16)
     through ``run_train_task`` (8 steps, 2 rounds), the counters read around it
     (every K1 and K2 entry, exactly so many a pod-step), every pod's params
     bit-equal to the master after each round; time 3 warm rounds and the outer
     step alone, profile one of each, print the bytes a round crosses the pod
     boundary; then its checkpointed task (8 steps, a checkpoint every 8) and a
     strict eval-task restore at full width and LOCAL_SGD_TASK_LAYERS (a
     28-layer save is 30.8 GiB);
 11. the cells (``repro_torch.launch.steps.build_cell``) at qwen3-0.6b's full
     width and depth, cut in batch (see ``CELLS_ARCH``): train_4k one step under
     remat none, full and dots from one state and batch (loss, grad_norm and
     params bit-equal; peak memory full < dots < none; launches exact),
     prefill_32k (K1 at S = 32,768 against its plain version in f32 and bf16,
     timed beside its bound and SDPA; the logits against forward's last
     position, a wiring check), decode_32k (16 steps on the prefill's cache) and
     the Titchener round; the dry-run of the train cell (``roofline/op_stats.py``
     on fake tensors, in a CPU process started after the build on a core that
     the script then leaves to it) beside the card's peak and step; in the same
     process, on PyTorch's fake process group, the dry-run of the Titchener
     round on a (2, 1, 1) ("pod", "data", "model") world, whose cross-pod bytes
     must equal what a rank sent over "pod" a round in phase 10's two ranks, and
     of qwen3-32b/decode_32k on the (2, 16, 16) mesh of 512 fake ranks (its
     per-device peak, terms and fit); mamba2-2.7b's long_500k cell (its decode
     in f32 at 4 layers against the prefill); ``examples/torch_train_100m.py
     --steps 300``.

The last three lines of standard output are the card line, one JSON object with
each kernel's numbers, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside a checkout, it exits nonzero and prints no result.

``--k1-bwd-against DIR`` runs phases 1-2, then only K1's backward against the one
of the checkout at DIR (built from DIR's source into a library of its own): f32
results bit-equal over the check sweep, bf16 results of both within the gate
(and how many bit-equal), and the bf16 times of both in turns (DIR's, this,
this, DIR's); at head dim 256 too, where DIR's has it.
``--k2-bwd-against DIR`` does the same for K2's four backward entry points (f32
dx bit-equal; the gated entry's dy and dz bit-equal where each row's sums keep
their order, rows of up to 128 vectors, and elsewhere the differing elements
counted; every output of both within the gate), and profiles each design once at
the training shapes (the gated one at mamba2-2.7b's and zamba2-7b's), kernel by
kernel. ``--k3-bwd-against DIR`` does the
same for K3's backward (f32 results bit-equal over the backward sweep; bf16 of both
within the gate; bf16 times in turns at the training shape; both designs profiled
by kernel). ``--sass-against DIR`` checks that every kernel of DIR's
``csrc/flash_attention.cu``, ``csrc/rmsnorm.cu`` and ``csrc/ssd_scan.cu`` compiles
to the same SASS here
(``cuobjdump -sass``) and names the kernels this checkout adds and any that
differ, SASS_REPLACED's named exceptions (the older designs of the gated backward
and of the split-row entries, each with its reason) aside; then it times K2's gated
entries and the four split-row entries of both checkouts in turns, the split-row
ones with the L2 flushed, each checkout's through its own wrappers. The flags may
be given together.
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
# runs the configs' 1.25. A MoE prefill's kernels count each layer's routing
# statistics (five kernels) and their one stack, which a forward's aux reads. The cross-attending families: whisper-medium (encdec) at
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
     "kernels": {"prefill": 3_036, "decode": 3_000}},
    {"arch": "qwen3-moe-235b-a22b", "layers": 2, "params": 6_220_173_824, "f32_leaves": (),
     "toks": [(2, 601)], "check_layers": (None, None), "deep_prefill_tol": 0.08,
     "launches": {"flash_attention": (2, 0), "rmsnorm": (1, 1), "add_rmsnorm": (4, 4),
                  "qk_norm_rope": (2, 2)},
     "kernels": {"prefill": 147, "decode": 135}},
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
# the elastic phase: TRAIN's run (4 steps of 4 x 2048 tokens, seed 0) re-meshed after
# step 2 onto a one-rank NCCL (data=1, model=1) DeviceMesh and back, against an
# uninterrupted Trainer; then the sharded forward (DTensor params, a 4 x 512 batch on
# its batch spec) on that mesh; then an ElasticController on a management plane of
# the plane phase's local planes. A forward launches K1 once a layer, K2's rmsnorm
# once (ln1 of layer 0), add_rmsnorm twice a layer and qk_norm_rope once a layer.
ELASTIC_PATH = "qwen3-0.6b elastic"
ELASTIC_SPLIT = 2                     # steps before the re-mesh; TRAIN["steps"] in all
ELASTIC_FWD = (4, 512)
ELASTIC_FWD_LAUNCHES = {"flash_attention": 28, "rmsnorm": 1, "add_rmsnorm": 56,
                        "qk_norm_rope": 28}
ELASTIC_LEASE_TICKS = 20              # ticks a lost cluster's lease may take to expire
# the tensor-parallel phase: TRAIN's tokens (4 x 2048, seed 0) for 3 steps on a one-rank
# NCCL (data=1, model=1) DeviceMesh against the one-device Trainer; a save there
# restored on one device; SERVE's 8 requests through a Server there against the
# one-device Server
TP_PATH = "qwen3-0.6b tensor-parallel"
TP_STEPS = 3
# the ssm and hybrid families' tensor-parallel code (phase_ssm_tensor_parallel):
# K2's gated norm over a split row, d_inner 5,120 (mamba2-2.7b) and 7,168
# (zamba2-7b) split 2, 4 and 8 ways, checked at a ragged row count, a decode batch
# and the training rows, timed at the training rows
SPLIT_WIDTHS, SPLIT_WAYS = (5120, 7168), (2, 4, 8)
SPLIT_ROWS = ((3, 5), (4, 1), (1, 2048))
SPLIT_NAMES = ("gated_rmsnorm_stats", "gated_rmsnorm_split", "gated_rmsnorm_split_dot",
               "gated_rmsnorm_split_bwd")
# (b) a one-rank NCCL (1, 1) mesh: mamba2-2.7b and zamba2-7b Trainers at full width
# cut in depth (mamba2 4 layers; zamba2 one group of 6 and one tail layer), 2 steps
# of one 2,048-token sequence, and a mamba2 Server at full depth, bit-equal to one
# device; (c) two gloo ranks on the one card as a (1, 2) mesh: the same Trainers
# and a short serve, held against one device at the bf16 gates
SSM_TP_PATH = {"mamba2-2.7b": "mamba2-2.7b tensor-parallel",
               "zamba2-7b": "zamba2-7b tensor-parallel"}
SSM_TP2_PATH = {"mamba2-2.7b": "mamba2-2.7b (1, 2) ranks",
                "zamba2-7b": "zamba2-7b (1, 2) ranks"}
SSM_TP_LAYERS = {"mamba2-2.7b": 4, "zamba2-7b": 7}
SSM_TP_STEPS = 2
SSM_TP_TRAIN = {"reduced": False, "seq_len": 2048, "global_batch": 1, "microbatches": 1}
SSM_TP_SERVE = {"reduced": False, "slots": 2, "max_len": 256}
SSM_TP_PROMPTS = [([(7 * i + 3) % 30000 for i in range(96)], 6), ([11, 12, 13], 5),
                  ([(5 * i) % 30000 for i in range(40)], 4)]
SSM_TP_DECODE = 4          # teacher-forced decode steps held against one device
SSM_TP_LOSS_TOL = 0.02     # tests/test_torch_train.py's BF16_LOSS_TOL
SSM_TP_LOGIT_TOL = 0.08    # tests/test_torch_model.py's BF16_TOL
# the encdec and vlm families' tensor-parallel code (phase_xattn_tensor_parallel):
# (b) on a one-rank NCCL (1, 1) mesh a whisper-medium Trainer at full width and 4 + 4
# layers (its checkpointed task's depth), 2 steps of one 2,048-token sequence over
# the Trainer's 1,500 random frames, and teacher-forced prefill and decode steps
# (XATTN_TP_CALLS) of whisper and llama-3.2-vision at one group (4 self layers and
# a gated cross layer onto its 1,601 patches), random frames and patches, every gate
# at CROSS_GATE, all bit-equal to one device; (c) two gloo ranks on the one card as a
# (1, 2) mesh: the same Trainer and the same teacher-forced calls at the gates
# below. On (1, 2) whisper's cross K/V splits its 1,500 frames (750 a rank, joined
# by log-sum-exp) and llama-vision's its 8 kv heads (1,601 is a prime)
XATTN_TP_PATH = {"whisper-medium": "whisper-medium tensor-parallel",
                 "llama-3.2-vision-90b": "llama-3.2-vision-90b tensor-parallel"}
XATTN_TP2_PATH = {"whisper-medium": "whisper-medium (1, 2) ranks",
                  "llama-3.2-vision-90b": "llama-3.2-vision-90b (1, 2) ranks"}
XATTN_TP_TRAIN = {"arch": "whisper-medium", "reduced": False, "seq_len": 2048,
                  "global_batch": 1, "microbatches": 1}
XATTN_TP_TRAIN_LAYERS = 4      # encoder and decoder layers each
XATTN_TP_STEPS = 2
# the teacher-forced calls: (arch, dtype, its decoder layers, None: every one; the
# (1, 2) ranks' gate against one device, None: printed only). As the serving path's
# checks (PATHS' check_layers) whisper's bf16 gate is held at 4 decoder layers over
# its 24-layer encoder: at 48 layers bf16 rounding drifts past it on one device
# too; at full depth the f32 logits are held at F32_GATE
F32_GATE = 1e-4            # tests/test_torch_model.py's F32_TOL
XATTN_TP_CALLS = [("whisper-medium", "bfloat16", None, None),
                  ("whisper-medium", "bfloat16", 4, SSM_TP_LOGIT_TOL),
                  ("whisper-medium", "float32", None, F32_GATE),
                  ("llama-3.2-vision-90b", "bfloat16", 5, SSM_TP_LOGIT_TOL)]
XATTN_TP_PROMPT = [(7 * i + 5) % 30000 for i in range(96)]
XATTN_TP_DECODE = 4            # teacher-forced decode steps after the prefill
XATTN_TP_SEED = 21             # the frames' and patches' generator
# the moe family's expert parallelism (``phase_moe_tensor_parallel``): a deepseek-moe
# Trainer at full width and MOE_TP_TRAIN_LAYERS (2 steps of one 2,048-token sequence
# at the config's capacity 1.25, drops happening) and the teacher-forced calls of
# MOE_TP_CALLS (arch, layers) in bf16 at full width, (b) on a one-rank NCCL mesh and
# (c) on two gloo ranks sharing the card as a (1, 2) mesh, each holding half of every
# layer's experts (32 of 64, 64 of 128); (c) held to one device's at the gates below
MOE_TP_PATH = {"deepseek-moe-16b": "deepseek-moe-16b expert-parallel",
               "qwen3-moe-235b-a22b": "qwen3-moe-235b-a22b expert-parallel"}
MOE_TP2_PATH = {"deepseek-moe-16b": "deepseek-moe-16b (1, 2) ranks",
                "qwen3-moe-235b-a22b": "qwen3-moe-235b-a22b (1, 2) ranks"}
MOE_TP_TRAIN = {"arch": "deepseek-moe-16b", "reduced": False, "seq_len": 2048,
                "global_batch": 1, "microbatches": 1}
MOE_TP_TRAIN_LAYERS = 2
MOE_TP_STEPS = 2
MOE_TP_CALLS = [("deepseek-moe-16b", 4), ("qwen3-moe-235b-a22b", 2)]
MOE_TP_LOSS_TOL = 5e-3     # the (1, 2) losses against one device's
MOE_TP_NORM_TOL = 0.02     # the (1, 2) grad norms: 0.02 + 0.02|x|

# local SGD with its pods on ranks of their own (phase_local_sgd_pods): qwen3-0.6b at
# full width and depth, bf16, 2 pods of H = 2 inner steps of 1 x 2048 tokens a round,
# 2 rounds, (a) on a one-rank NCCL ("pod", "data", "model") mesh and (b) on two gloo
# ranks sharing the card as a (2, 1, 1) mesh, one pod a rank; both bit-equal to the
# one-device local-SGD Trainer, compared by per-leaf bit digests (the one-device
# state is 30.8 GiB: the runs go in turn)
LOCAL_SGD_PODS = {"arch": "qwen3-0.6b", "reduced": False, "seq_len": 2048, "global_batch": 2,
                  "mode": "local_sgd", "n_pods": 2, "local_sgd": {"inner_steps": 2},
                  "steps": 4}
LOCAL_SGD_PODS_PATH = "qwen3-0.6b local_sgd pods"
LOCAL_SGD_PODS2_PATH = "qwen3-0.6b local_sgd (2, 1, 1) ranks"
POD_AXES = ("pod", "data", "model")

# the launcher phase: ``python -m repro_torch.launch.train`` with its defaults (driver
# mode: a master and 2 private clusters; 30 steps of 8 x 64 tokens; qwen3-0.6b at full
# width and depth on the card), then ``--direct``; ``launch.serve`` with its defaults
# (6 requests of 8 new tokens, 4 slots, a 128-token cache) direct and ``--driver``
LAUNCH_PATH = "qwen3-0.6b launchers"
# the port's examples on the card, after the launchers: qwen3-0.6b at full width cut
# to 4 layers (at full depth they took 84.4 s of the script, most of it writing
# 10.5 GB checkpoints; the launchers and the plane run the same code at full depth)
EXAMPLE_LAYERS = 4
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
K2_BWD_NAMES = ("rows_bwd_kernel", "qk_norm_rope_bwd_kernel", "gated_bwd_kernel",
                "gated_fold_kernel")
# K2's backward entry points: one launch each, dscale folded in
K2_BWD_ENTRIES = ("rmsnorm_bwd", "add_rmsnorm_bwd", "qk_norm_rope_bwd")
# gated_rmsnorm_bwd's kernels a call: its row pass and the fold of its dscale rows
GATED_BWD_KERNELS = 2

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
# (its two saves and the restore took 39.5 s of the script at 4 layers)
SSM_TASK_LAYERS = 2
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
# the gated norm's backward: K2's backward sweep (zamba2's d_inner 7168 in it),
# mamba2's training shape, and the edges of gated_bwd_kernel's grid at both widths:
# a single row, rows fewer than the SMs, row counts that no team count divides
# (2,047 and 1,031 are prime), and the widest f32 row the wrapper takes (8,192,
# whose f32 rows take 4 vectors a thread, not 2)
GATED_BWD_TIMED = [(1, 2048, 5120), (1, 2048, 7168)]   # mamba2-2.7b's, zamba2-7b's
GATED_BWD_EDGES = [(1, 1, 5120), (1, 1, 7168), (1, 100, 5120), (1, 100, 7168),
                   (1, 2047, 5120), (1, 1031, 7168), (1, 3, 8192)]
GATED_BWD_SWEEP = NORM_BWD_SWEEP + GATED_BWD_EDGES + [GATED_BWD_TIMED[0]]
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
# its checkpointed train task and the eval task's strict restore: 4 encoder and 4
# decoder layers (a full-depth save is ~14 GB and took 66 s of the script)
WHISPER_TASK_LAYERS = 4
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
# through run_train_task; its checkpointed task at 2 layers (a 28-layer save is
# 30.8 GiB of state, a 4-layer one 16.46 GB)
LOCAL_SGD = {"arch": "qwen3-0.6b", "reduced": False, "seq_len": 2048, "global_batch": 4,
             "mode": "local_sgd", "n_pods": 2, "local_sgd": {"inner_steps": 4}, "steps": 8}
LOCAL_SGD_PATH = "qwen3-0.6b local_sgd"
LOCAL_SGD_TASK_LAYERS = 2
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
# the production cell the dry-run process traces on the fake 512-rank (2, 16, 16)
# mesh: an arch that never runs on the card, one step, quick to trace
DRYRUN_PRODUCTION = ("qwen3-32b", "decode_32k", "multi")
# what the script measured for later phases to hold predictions against
MEASURED = {}
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


# written, then read, between the launches time_cold_ms times: 5x the H100's 50 MB L2
L2_FLUSH_BYTES = 256 * 2**20
_FLUSH = []


def flush_l2() -> None:
    """Write a buffer of L2_FLUSH_BYTES, then read it: the L2 then holds none of
    what came before, and only clean lines, so the next call reads its inputs
    from device memory and pays no write-back of the flush's own lines."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda"))
    _FLUSH[0].zero_()
    _FLUSH[0].sum()


def time_cold_ms(fn, n: int = 20) -> float:
    """Median device time of one call over ``n`` calls, each after flush_l2
    (outside its event pair), after warm-up: the call finds none of its inputs in
    the L2, as a byte bound over device memory assumes. A sleep kernel holds the
    card while the host enqueues every call."""
    for _ in range(3):
        fn()
    flush_l2()
    torch.cuda.synchronize()
    start = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(100_000_000)
    for i in range(n):
        flush_l2()
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(start, end))


def kernel_cold_ms(fn, names, n: int = 20) -> float:
    """The device time of one call's kernels whose names hold one of ``names``
    (one launch each a call), from torch.profiler over ``n`` calls, each after
    flush_l2: the kernels' own time, without the launch and the event pair that
    time_cold_ms also counts. The window leads with SPINS sentinel kernels, which
    take any loss at its start; fails unless every call's kernels are in it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SPINS):
            torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(n):
            flush_l2()
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and any(name in e.key for name in names)]
    launches = sum(e.count for e in mine)
    check(launches == n * len(names), f"kernel_cold_ms: {launches} launches of {names} in "
          f"the trace, want {n * len(names)}")
    return sum(e.self_device_time_total for e in mine) / n / 1e3


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
            "qk_norm_rope_bwd": RN.qk_norm_rope_bwd_cuda, "ssd_scan_bwd": SS.ssd_scan_bwd_cuda,
            "gated_rmsnorm_stats": RN.gated_rmsnorm_stats_cuda,
            "gated_rmsnorm_split": RN.gated_rmsnorm_split_cuda,
            "gated_rmsnorm_split_dot": RN.gated_rmsnorm_split_dot_cuda,
            "gated_rmsnorm_split_bwd": RN.gated_rmsnorm_split_bwd_cuda}


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


def gated_bwd_case(gen, shape, dtype):
    """y, z, scale, dout of one gated norm backward case."""
    return (randn(shape, dtype, gen), randn(shape, dtype, gen), randn(shape[-1:], dtype, gen),
            randn(shape, dtype, gen))


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


# the modes of K2's kernels that take one as their last template argument
K2_MODES = {"rows_bwd_kernel": ("plain", "add", "gated"),
            "split_rows_kernel": ("squares", "dot", "norm")}


def gated_registers(kernels: list, strict: bool = True) -> list:
    """"name<args> registers" of each kernel that must not spill (K1's forward in
    both designs at every head dim, its bf16 backward ones, every instance of K2's
    three backward kernels and of its two split-row kernels, and K3's bf16 backward
    ones), failing on any that spills (strict) or naming its spill stores. Mode 2
    of rows_bwd_kernel, the gated one, is an older checkout's."""
    out = []
    for kernel, stores, r in kernels:
        k1 = re.search(r"(bwd_\w+_bf16_kernel|flash_fwd_bf16_kernel|flash_fwd_kernel)ILi(\d+)E",
                       kernel)
        k2 = re.search(r"(rows_bwd_kernel|qk_norm_rope_bwd_kernel|gated_bwd_kernel|fold"
                       r"|split_rows_kernel|split_bwd_kernel)"
                       r"I(f|13__nv_bfloat16)Li(\d+)E(Li([012])E)?", kernel)
        k3 = re.search(r"(ssd_scan_bwd_states|ssd_scan_bwd_grad)ILi(\d+)ELi(\d+)E"
                       r"|(ssd_scan_bwd_bf16_finish)E", kernel)
        if k1:
            name = f"{k1.group(1)}<{k1.group(2)}>"
        elif k3:
            name = k3.group(4) or f"{k3.group(1)}<N={k3.group(2)}, P={k3.group(3)}>"
        elif k2:
            modes = K2_MODES.get(k2.group(1))
            add = f", {modes[int(k2.group(5))]}" if modes and k2.group(5) else ""
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
    output's strided views; gated_rmsnorm's backward on K2's backward sweep, the
    edges of its grid and the training shape. Then each is timed at mamba2-2.7b's
    training shape, and at zamba2-7b's, beside its bound and its plain version (no
    library call computes either); K3's
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
                if shape == GATED_BWD_TIMED[0] and dtype == bf16:
                    worst = max(worst, max_err(g, w))
    print(f"gated_rmsnorm_bwd: matches its plain version on {len(GATED_BWD_SWEEP)} shapes (f32 "
          f"against the f64 evaluation from the forward's f32 gate, bf16; dscale included), "
          f"two runs bit-equal")
    # timed at mamba2-2.7b's training rows (the JSON row) and zamba2-7b's (beside it)
    timed = []
    for shape in GATED_BWD_TIMED:
        y, z, dout = (randn(shape, bf16, gen) for _ in range(3))
        sc = randn(shape[-1:], bf16, gen)
        t = {"ms": time_ms(lambda: RN.gated_rmsnorm_bwd_cuda(y, z, sc, dout)),
             "plain_ms": time_ms(lambda: RN.gated_rmsnorm_bwd_plain(y, z, sc, dout))}
        nbytes = (5 * y.numel() + 2 * sc.numel()) * y.element_size()  # y, z, dout in; dy, dz out
        t["bound_ms"], t["bound_by"] = bound(nbytes, 20 * y.numel(), PEAK_FLOPS[f32])
        print(f"gated_rmsnorm_bwd {shape} bf16: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library none, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}, {nbytes / 1e6:.2f} MB), {t['bound_ms'] / t['ms']:.2f} of it")
        timed.append(t)
        del y, z, dout
    rows.append({"name": "gated_rmsnorm_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "replaces": "src/repro/kernels/rmsnorm.py:11", "max_abs_err": worst,
                 **timed[0], "library_ms": None, "zamba2": timed[1]})
    return rows


def split_parts(t: torch.Tensor, ways: int) -> list:
    """The ``ways`` contiguous column slices of t's last dim, each contiguous: what
    the ranks of a "model" axis of that size hold of a split row."""
    return [c.contiguous() for c in t.chunk(ways, dim=-1)]


def split_sums_exact(y, z, sc, dout):
    """The row sums of the split-row entries (t^2; dout * scale * t) evaluated in
    f64 from the gate t = y * silu(z) in y's dtype, as the kernels and the plain
    versions form it: two f32 sums of a row in different orders differ by more
    than K2's 1e-5 where dout * scale * t cancels, so the f32 kernels are held
    against the exact sums, as ``exact`` holds the f32 backward."""
    from repro_torch.kernels import rmsnorm as RN
    t = RN._gate(y, z).double()
    return (t * t).sum(dim=-1), (dout.double() * sc.double() * t).sum(dim=-1)


def split_bwd_exact(y, z, sc, dout, ss, dot, width: int):
    """gated_rmsnorm_split_bwd's outputs evaluated in f64 from the f32 gate t =
    y * silu(z) and the given row sums, as ``gated_bwd_exact`` evaluates the
    one-launch backward: the kernel sums dscale over the rows in f64."""
    silu = F.silu(z)
    t = (y * silu).double()
    rstd = torch.rsqrt(ss.double()[..., None] / width + 1e-6)
    dt = rstd * dout.double() * sc.double() - t * rstd ** 3 * (dot.double()[..., None] / width)
    dscale = (dout.double() * t * rstd).reshape(-1, y.shape[-1]).sum(dim=0)
    zd = z.double()
    sig = torch.sigmoid(zd)
    return dt * silu.double(), dt * y.double() * sig * (1 + zd * (1 - sig)), dscale


def split_gated(y, z, sc, ways: int, width: int):
    """gated_rmsnorm of [.., width] rows split ``ways`` ways through the split-row
    kernels, the row sums added here in place of the all-reduce. Returns the
    whole output."""
    from repro_torch.kernels import rmsnorm as RN
    ys, zs, ss_ = split_parts(y, ways), split_parts(z, ways), split_parts(sc, ways)
    total = sum(RN.gated_rmsnorm_stats_cuda(a, b) for a, b in zip(ys, zs))
    return torch.cat([RN.gated_rmsnorm_split_cuda(a, b, c, total, width)
                      for a, b, c in zip(ys, zs, ss_)], dim=-1)


def split_gated_bwd(y, z, sc, dout, ways: int, width: int):
    """(dy, dz, dscale) of ``split_gated`` through the split-row backward kernels,
    the row sums of both directions added here in place of the all-reduces."""
    from repro_torch.kernels import rmsnorm as RN
    parts = [split_parts(t, ways) for t in (y, z, sc, dout)]
    ss = sum(RN.gated_rmsnorm_stats_cuda(a, b) for a, b, _, _ in zip(*parts))
    dot = sum(RN.gated_rmsnorm_split_dot_cuda(*p) for p in zip(*parts))
    outs = [RN.gated_rmsnorm_split_bwd_cuda(*p, ss, dot, width) for p in zip(*parts)]
    return tuple(torch.cat([o[i] for o in outs], dim=-1) for i in range(3))


def phase_split_norm(gen) -> list:
    """K2's gated norm over a split row (SPLIT_NAMES), each entry on the card: the
    rows of mamba2-2.7b's and zamba2-7b's d_inner split 2, 4 and 8 ways, the row
    sums added in-process in place of the all-reduce, both ways, in f32 and bf16
    at SPLIT_ROWS: each entry against its plain version on the same slices at
    K2's gates (in f32 the row sums and the backward against their f64 evaluation:
    ``split_sums_exact``, ``split_bwd_exact``),
    and the whole row put back together against the whole-row kernel
    and the whole-row plain version (f32 backward against the f64 evaluation);
    two runs bit-equal. Then timed in bf16 at the training rows beside its byte
    bound, with the L2 flushed before each call (time_cold_ms: "ms", which no
    reading may beat) and warm (time_ms: "warm_ms", back to back; a warm
    reading under the bound is the L2's), the whole-row kernel on the same local
    row and on the whole row warm beside them. Returns one JSON row per entry
    (mamba2's two-way split, the main path's; the other five points under
    "others")."""
    from repro_torch.kernels import rmsnorm as RN
    f32, bf16 = torch.float32, torch.bfloat16
    t_phase = time.perf_counter()
    worst = {n: 0.0 for n in SPLIT_NAMES}
    n_cases = 0
    for D in SPLIT_WIDTHS:
        for ways in SPLIT_WAYS:
            for rows in SPLIT_ROWS:
                for dtype in (f32, bf16):
                    shape = rows + (D,)
                    y, z, sc, dout = gated_bwd_case(gen, shape, dtype)
                    tol, tag = RMS_TOL[dtype], f"{shape} / {ways} {dtype}"
                    parts = [split_parts(t, ways) for t in (y, z, sc, dout)]
                    # each entry against its plain version on the same slices
                    ss = [RN.gated_rmsnorm_stats_cuda(a, b) for a, b, _, _ in zip(*parts)]
                    dots = [RN.gated_rmsnorm_split_dot_cuda(*p) for p in zip(*parts)]
                    exact_sums = [split_sums_exact(*p) for p in zip(*parts)]
                    for name, got, want in (("gated_rmsnorm_stats", ss,
                                             [e[0] for e in exact_sums]),
                                            ("gated_rmsnorm_split_dot", dots,
                                             [e[1] for e in exact_sums])):
                        for g, w in zip(got, want):
                            check(close(g, w, tol), f"{name} {tag}: max err {max_err(g, w)}")
                            worst[name] = max(worst[name], max_err(g, w))
                    total, dot = sum(ss), sum(dots)
                    for p in zip(*parts):
                        g = RN.gated_rmsnorm_split_cuda(p[0], p[1], p[2], total, D)
                        w = RN.gated_rmsnorm_split_plain(p[0], p[1], p[2], total, D)
                        check(close(g, w, tol), f"gated_rmsnorm_split {tag}: max err "
                              f"{max_err(g, w)}")
                        worst["gated_rmsnorm_split"] = max(worst["gated_rmsnorm_split"],
                                                           max_err(g, w))
                        g = RN.gated_rmsnorm_split_bwd_cuda(*p, total, dot, D)
                        w = (split_bwd_exact(*p, total, dot, D) if dtype == f32 else
                             RN.gated_rmsnorm_split_bwd_plain(*p, total, dot, D))
                        for i, (a, b) in enumerate(zip(g, w)):
                            check(close(a, b, tol), f"gated_rmsnorm_split_bwd {tag} output "
                                  f"{i}: max err {max_err(a, b)}")
                            worst["gated_rmsnorm_split_bwd"] = max(
                                worst["gated_rmsnorm_split_bwd"], max_err(a, b))
                    # the whole row put back together
                    out = split_gated(y, z, sc, ways, D)
                    check(torch.equal(out, split_gated(y, z, sc, ways, D)),
                          f"gated split {tag}: two runs differ")
                    for label, w in (("the whole-row kernel", RN.gated_rmsnorm_cuda(y, z, sc)),
                                     ("the whole-row plain", RN.gated_rmsnorm_plain(y, z, sc))):
                        check(close(out, w, tol), f"gated split {tag} against {label}: max "
                              f"err {max_err(out, w)}")
                    got = split_gated_bwd(y, z, sc, dout, ways, D)
                    again = split_gated_bwd(y, z, sc, dout, ways, D)
                    whole = RN.gated_rmsnorm_bwd_cuda(y, z, sc, dout)
                    want = (gated_bwd_exact(y, z, sc, dout) if dtype == f32
                            else RN.gated_rmsnorm_bwd_plain(y, z, sc, dout))
                    for i, (g, r, k, w) in enumerate(zip(got, again, whole, want)):
                        check(torch.equal(g, r), f"gated split bwd {tag} output {i}: two runs "
                              "differ")
                        for label, ref in (("the whole-row kernel", k), ("the plain", w)):
                            check(close(g, ref, tol), f"gated split bwd {tag} output {i} "
                                  f"against {label}: max err {max_err(g, ref)}")
                    n_cases += 1
    print(f"gated norm over a split row: {n_cases} cases (d_inner {SPLIT_WIDTHS} split "
          f"{SPLIT_WAYS} ways, rows {SPLIT_ROWS}, f32 and bf16): each entry within K2's gates "
          f"of its plain version, the whole row within them of the whole-row kernel and plain "
          f"version both ways, two runs bit-equal")
    # timed in bf16 at the training rows: each entry, and beside them the one-launch
    # whole-row kernels on the same local row and on the whole row; first the floor
    # that time_cold_ms puts under any launch
    tiny = torch.zeros(16, device="cuda")
    print(f"gated split row: a 16-element torch.add timed as the entries, L2 flushed "
          f"{time_cold_ms(lambda: torch.add(tiny, tiny, out=tiny)):.4f} ms, warm "
          f"{time_ms(lambda: torch.add(tiny, tiny, out=tiny)):.4f} ms: the floor a launch")
    rows, timed = [], {}
    for D in SPLIT_WIDTHS:
        for ways in SPLIT_WAYS:
            y, z, sc, dout = gated_bwd_case(gen, (1, 2048, D), bf16)
            a, b, c, g = (split_parts(t, ways)[0] for t in (y, z, sc, dout))
            ss = RN.gated_rmsnorm_stats_cuda(a, b) * ways
            dot = RN.gated_rmsnorm_split_dot_cuda(a, b, c, g)
            n, e, Dl, R = a.numel(), a.element_size(), a.shape[-1], a.numel() // a.shape[-1]
            # entry -> (kernel, plain, bytes: each input read once, each output written once,
            # f32 flops, the names of its kernels)
            rows_k, bwd_k = ("split_rows_kernel",), ("split_bwd_kernel", "gated_fold_kernel")
            entries = {
                "gated_rmsnorm_stats": (lambda: RN.gated_rmsnorm_stats_cuda(a, b),
                                        lambda: RN.gated_rmsnorm_stats_plain(a, b),
                                        2 * n * e + 4 * R, 7 * n, rows_k),
                "gated_rmsnorm_split": (lambda: RN.gated_rmsnorm_split_cuda(a, b, c, ss, D),
                                        lambda: RN.gated_rmsnorm_split_plain(a, b, c, ss, D),
                                        3 * n * e + Dl * e + 4 * R, 8 * n, rows_k),
                "gated_rmsnorm_split_dot": (
                    lambda: RN.gated_rmsnorm_split_dot_cuda(a, b, c, g),
                    lambda: RN.gated_rmsnorm_split_dot_plain(a, b, c, g),
                    3 * n * e + Dl * e + 4 * R, 8 * n, rows_k),
                "gated_rmsnorm_split_bwd": (
                    lambda: RN.gated_rmsnorm_split_bwd_cuda(a, b, c, g, ss, dot, D),
                    lambda: RN.gated_rmsnorm_split_bwd_plain(a, b, c, g, ss, dot, D),
                    5 * n * e + 2 * Dl * e + 8 * R, 20 * n, bwd_k)}
            one = {"fwd local": time_ms(lambda: RN.gated_rmsnorm_cuda(a, b, c)),
                   "bwd local": time_ms(lambda: RN.gated_rmsnorm_bwd_cuda(a, b, c, g)),
                   "fwd whole": time_ms(lambda: RN.gated_rmsnorm_cuda(y, z, sc)),
                   "bwd whole": time_ms(lambda: RN.gated_rmsnorm_bwd_cuda(y, z, sc, dout))}
            line = []
            for name, (kernel, plain, nbytes, flops, names) in entries.items():
                t = {"ms": time_cold_ms(kernel), "warm_ms": time_ms(kernel),
                     "kernel_ms": kernel_cold_ms(kernel, names), "plain_ms": time_ms(plain)}
                t["bound_ms"], t["bound_by"] = bound(nbytes, flops, PEAK_FLOPS[f32])
                check(t["ms"] >= t["bound_ms"], f"{name} [2048, {Dl}] bf16 with the L2 "
                      f"flushed: {t['ms']} ms beats its device-memory bound {t['bound_ms']} ms")
                timed[(name, D, ways)] = t
                warm = (f"{t['bound_ms'] / t['warm_ms']:.2f} of it" if t["warm_ms"] >= t["bound_ms"]
                        else "under it: the L2's")
                alone = (f"{t['bound_ms'] / t['kernel_ms']:.2f}" if t["kernel_ms"] >= t["bound_ms"]
                         else "under the bound: its stores still in the L2")
                line.append(f"{name} L2 flushed {t['ms']:.4f} ms ({t['bound_ms'] / t['ms']:.2f} of "
                            f"the bound; its kernels alone {t['kernel_ms']:.4f} ms, {alone}), "
                            f"warm {t['warm_ms']:.4f} ms ({warm}), plain "
                            f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.5f} ms "
                            f"{t['bound_by']} ({nbytes / 1e6:.2f} MB)")
            fwd = timed[("gated_rmsnorm_stats", D, ways)]["warm_ms"] + \
                timed[("gated_rmsnorm_split", D, ways)]["warm_ms"]
            bwd = timed[("gated_rmsnorm_split_dot", D, ways)]["warm_ms"] + \
                timed[("gated_rmsnorm_split_bwd", D, ways)]["warm_ms"]
            print(f"gated split row [2048, {D}] / {ways} = [2048, {Dl}] bf16: "
                  f"{'; '.join(line)}; warm forward {fwd:.4f} ms against the whole-row kernel "
                  f"{one['fwd local']:.4f} ms on the same local row ({fwd / one['fwd local']:.2f}x)"
                  f" and {one['fwd whole']:.4f} ms on the whole row; backward {bwd:.4f} ms "
                  f"against {one['bwd local']:.4f} ({bwd / one['bwd local']:.2f}x) and "
                  f"{one['bwd whole']:.4f} ms")
            del y, z, sc, dout, a, b, c, g
    for name in SPLIT_NAMES:
        main = timed[(name, SPLIT_WIDTHS[0], SPLIT_WAYS[0])]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                     "replaces": "src/repro/kernels/rmsnorm.py:11", "max_abs_err": worst[name],
                     **main, "library_ms": None,
                     "others": {f"{D}/{w}": {k: timed[(name, D, w)][k]
                                             for k in ("ms", "warm_ms", "kernel_ms", "bound_ms")}
                                for D in SPLIT_WIDTHS for w in SPLIT_WAYS}})
    print(f"gated split row: phase {time.perf_counter() - t_phase:.1f} s")
    return rows


@contextlib.contextmanager
def router_log(log: list):
    """Each MoE router call's (top-k indices, probabilities) appended to ``log``."""
    from repro_torch.models import moe as MOE
    real = MOE.router_probs

    def logged(*args):
        out = real(*args)
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


def phase_elastic(card: str) -> dict:
    """Re-mesh mid-training (``runtime/elastic.py``): qwen3-0.6b at full width and
    depth, TRAIN's 4 x 2048 tokens from seed 0, 2 steps, the state onto a one-rank
    NCCL ``DeviceMesh`` (data=1, model=1) under ``train_state_specs`` (every leaf a
    DTensor there) and back onto the Trainer's one-device plan (plain tensors),
    twice (each call timed; the first pays DTensor's lazy set-up), 2 more steps:
    every loss and state tensor bit-equal to an uninterrupted 4-step
    Trainer's, K1 and K2 launched exactly 4 x TRAIN_PER_STEP. Then the DTensor
    route: the params on that mesh and a 4 x 512 batch on its batch spec, the
    sharded forward's logits (a DTensor) bit-equal to the one-device forward's, its
    K1 and K2 launches exact. Then membership: an ``ElasticController`` on a
    management plane whose clusters run the plane phase's ``TorchLocalPlane``s sees
    a lost cluster leave once its lease expires, and a new one join, with no job
    and no save. Returns each kernel's launches in the train steps and the sharded
    forward."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.core.plane import ManagementPlane, SimLocalPlane
    from repro_torch.launch.steps import batch_pspecs, train_state_specs
    from repro_torch.models.model import Model
    from repro_torch.models.params import TensorDef
    from repro_torch.parallel.sharding import MeshPlan, OneDeviceMesh
    from repro_torch.runtime.elastic import ElasticController, remesh_state
    from repro_torch.runtime.local_plane import TorchLocalPlane
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
    from repro_torch.tree import tree_flatten_sorted

    t_phase = time.perf_counter()
    job = TrainJobConfig.from_job({"payload": dict(TRAIN)})
    steps = job.steps
    ref = Trainer(job)
    ref.run(steps)                                  # uninterrupted
    tr = Trainer(job)
    check(isinstance(tr.plan.mesh, OneDeviceMesh) and ref.ckpt is None and tr.ckpt is None,
          f"elastic: the Trainer's plan {tr.plan}")
    torch.cuda.synchronize()
    wrappers = reset_launches()
    tr.run(ELASTIC_SPLIT)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        plan1 = MeshPlan(mesh=mesh, fsdp=False)
        cfg = tr.arch_cfg

        def specs(plan):
            return train_state_specs(cfg, plan)

        remesh_ms = []

        def timed(state, old, new):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = remesh_state(state, old, new, specs)
            torch.cuda.synchronize()
            remesh_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        for _ in range(2):          # the first round trip pays DTensor's lazy set-up
            on_mesh = timed(tr.state, tr.plan, plan1)
            leaves = [t for _, t in tree_flatten_sorted(on_mesh)]
            check(all(isinstance(t, DTensor) and t.device_mesh == mesh for t in leaves),
                  "elastic: the state on the one-rank mesh is not DTensors on it")
            tr.state = timed(on_mesh, plan1, tr.plan)
            del on_mesh, leaves
            check(not any(isinstance(t, DTensor) for _, t in tree_flatten_sorted(tr.state)),
                  "elastic: the state back on the one-device plan holds DTensors")
        tr.run(steps - ELASTIC_SPLIT)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        losses, want = tr.metrics.series("loss"), ref.metrics.series("loss")
        got_state, ref_state = tree_flatten_sorted(tr.state), tree_flatten_sorted(ref.state)
        same = [p for (p, a), (q, b) in zip(got_state, ref_state)
                if p == q and a.dtype == b.dtype and torch.equal(a, b)]
        print(f"elastic: {TRAIN['arch']} full width, {cfg.num_layers} layers, "
              f"{TRAIN['global_batch']} x {TRAIN['seq_len']} tokens a step, re-meshed after "
              f"step {ELASTIC_SPLIT} onto a one-rank NCCL (1, 1) mesh and back, twice: "
              f"remesh_state ms (onto, back, onto, back) {[round(t, 3) for t in remesh_ms]} "
              f"[{card}]; losses {losses}, "
              f"uninterrupted {want}; {len(same)} of {len(ref_state)} state tensors "
              f"bit-equal; launches {launches}")
        check(tr.step == steps and losses == want,
              f"elastic: losses {losses} != the uninterrupted run's {want}")
        check(len(same) == len(ref_state) == len(got_state),
              f"elastic: {len(ref_state) - len(same)} state tensors differ from the "
              "uninterrupted run's")
        for name, n in launches.items():
            per = TRAIN_PER_STEP.get(name, 0)
            check(n == per * steps, f"elastic: {name} launched {n}, want {per * steps}")
        del ref
        gc.collect()
        torch.cuda.empty_cache()

        # -- the DTensor route: params and batch on the one-rank mesh
        B, S = ELASTIC_FWD
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                               dtype=torch.int32)
        sharded = Model(cfg, "cuda", plan1)
        params1 = remesh_state(tr.state["params"], tr.plan, plan1,
                               lambda p: Model(cfg, "cuda", p).param_specs())
        bspec = batch_pspecs(plan1, cfg, {"tokens": TensorDef((B, S), torch.int32)})
        batch1 = remesh_state({"tokens": tokens}, tr.plan, plan1, lambda p: bspec)
        with torch.no_grad():
            plain = tr.model.forward(tr.state["params"], {"tokens": tokens})[0]
            torch.cuda.synchronize()
            fwd = reset_launches()
            logits = sharded.forward(params1, batch1)[0]
            torch.cuda.synchronize()
            fwd_launches = {name: fn.launches for name, fn in fwd.items()}
            plain_ms = wall_ms(lambda: tr.model.forward(tr.state["params"],
                                                         {"tokens": tokens}), n=3)
            sharded_ms = wall_ms(lambda: sharded.forward(params1, batch1), n=3)
        want_pl = plan1.sharding(("batch", "seq", "vocab"), (B, S, cfg.vocab_size))
        equal = isinstance(logits, DTensor) and torch.equal(logits.full_tensor(), plain)
        print(f"elastic: sharded forward on the one-rank mesh, {B} x {S} tokens: logits "
              f"{type(logits).__name__} {tuple(logits.shape)} placements "
              f"{tuple(getattr(logits, 'placements', ()))}, bit-equal to the one-device "
              f"forward's: {equal}; {sharded_ms:.2f} ms, one-device {plain_ms:.2f} ms "
              f"[{card}]; launches {fwd_launches}")
        check(equal and tuple(logits.placements) == want_pl,
              "elastic: the sharded forward's logits differ from the one-device forward's")
        for name, n in fwd_launches.items():
            want_n = ELASTIC_FWD_LAUNCHES.get(name, 0)
            check(n == want_n, f"elastic: sharded forward: {name} launched {n}, want {want_n}")
            launches[name] += n
        del params1, batch1, logits, plain, sharded, tr
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # -- membership through the port's plane: a cluster lost, a cluster added
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True, local_plane=SimLocalPlane(caps=("control",)))
    for name in ("zone-a", "zone-b"):
        plane.add_cluster(name, local_plane=TorchLocalPlane(caps=PLANE_CAPS, device="cuda"))
    seen = []
    ElasticController(plane.overwatch, lambda m: seen.append(tuple(m)))
    plane.fabric.partition_cluster("zone-a")
    ticks = 0
    while (not seen or "zone-a" in seen[-1]) and ticks < ELASTIC_LEASE_TICKS:
        plane.tick()
        ticks += 1
    left = bool(seen) and "zone-a" not in seen[-1]
    plane.add_cluster("zone-c", local_plane=TorchLocalPlane(caps=PLANE_CAPS, device="cuda"))
    joined = bool(seen) and "zone-c" in seen[-1]
    print(f"elastic: the controller saw {seen} (zone-a lost, left after {ticks} ticks; "
          f"zone-c added); phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    check(left, f"elastic: zone-a not seen to leave in {ELASTIC_LEASE_TICKS} ticks: {seen}")
    check(joined and "zone-b" in seen[-1] and "master" in seen[-1],
          f"elastic: zone-c not seen to join: {seen}")
    return launches


def phase_tensor_parallel(card: str) -> dict:
    """The tensor-parallel route (``models/model.py``, ``launch/steps.py``,
    ``optim/adamw.py``) on a one-rank NCCL ("data", "model") ``DeviceMesh``, where
    every axis has size 1, so no collective runs: a qwen3-0.6b Trainer at full
    width and depth on that mesh (its state DTensors) takes TP_STEPS steps of
    TRAIN's 4 x 2048 tokens from seed 0, its losses, grad norms and every state
    tensor bit-equal to the one-device Trainer's, K1 and K2 launched exactly
    TP_STEPS x TRAIN_PER_STEP, each step's wall printed for both; its state, saved
    from the mesh (``checkpoint/manager.py`` gathers DTensor leaves), restores on
    one device bit-equal; a Server on the mesh serves SERVE's 8 requests with the
    one-device Server's greedy tokens, its launches exactly 8 prefills' and its
    decode steps'. Returns each kernel's launches in the mesh Trainer's steps and
    the mesh Server's run."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel.sharding import full_value
    from repro_torch.runtime.serve_loop import Server, ServeJobConfig
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
    from repro_torch.tree import tree_flatten_sorted

    t_phase = time.perf_counter()
    job = TrainJobConfig.from_job({"payload": dict(TRAIN, steps=TP_STEPS)})

    def timed_steps(tr) -> list:
        walls = []
        for _ in range(TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.step_once()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    def bits(state) -> list:
        return [(path, full_value(t)) for path, t in tree_flatten_sorted(state)]

    def same(a: list, b: list) -> int:
        return sum(p == q and x.dtype == y.dtype and torch.equal(x, y)
                   for (p, x), (q, y) in zip(a, b))

    ref = Trainer(job)
    ref_ms = timed_steps(ref)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        tr = Trainer(job, mesh=mesh)
        check(tr.model.ranked and all(isinstance(t, DTensor) and t.device_mesh == mesh
                                      for _, t in tree_flatten_sorted(tr.state)),
              "tensor-parallel: the Trainer's state on the one-rank mesh is not DTensors")
        torch.cuda.synchronize()
        wrappers = reset_launches()
        tp_ms = timed_steps(tr)
        launches = {name: fn.launches for name, fn in wrappers.items()}
        got, want = bits(tr.state), bits(ref.state)
        n_same = same(got, want)
        series = {k: (tr.metrics.series(k), ref.metrics.series(k)) for k in ("loss", "grad_norm")}
        print(f"tensor-parallel: {TRAIN['arch']} full width, {tr.arch_cfg.num_layers} layers, "
              f"{TRAIN['global_batch']} x {TRAIN['seq_len']} tokens a step on a one-rank NCCL "
              f"(1, 1) mesh: step ms {[round(t, 3) for t in tp_ms]}, one device "
              f"{[round(t, 3) for t in ref_ms]} [{card}]; losses {series['loss'][0]}, one "
              f"device {series['loss'][1]}; grad norms {series['grad_norm'][0]}, one device "
              f"{series['grad_norm'][1]}; {n_same} of {len(want)} state tensors bit-equal; "
              f"launches {launches}")
        for key, (a, b) in series.items():
            check(len(a) == TP_STEPS and a == b, f"tensor-parallel: {key} {a} != one device's {b}")
        check(n_same == len(want) == len(got),
              f"tensor-parallel: {len(want) - n_same} state tensors differ from one device's")
        for name, n in launches.items():
            per = TRAIN_PER_STEP.get(name, 0)
            check(n == per * TP_STEPS, f"tensor-parallel: {name} launched {n}, "
                  f"want {per * TP_STEPS}")

        # -- a save from the mesh, restored on one device
        directory = ROOT / "build" / "tp_checkpoint"
        shutil.rmtree(directory, ignore_errors=True)
        mgr = CheckpointManager(str(directory), keep=1)
        t0 = time.perf_counter()
        mgr.save(tr.step, tr.state, blocking=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, step, _ = mgr.restore(ref.state, step=tr.step)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        back = bits(restored)
        n_back = same(back, got)
        size = sum(t.numel() * t.element_size() for _, t in back) / 1e9
        print(f"tensor-parallel: a {size:.2f} GB save from the mesh {save_s:.2f} s, restored "
              f"on one device {restore_s:.2f} s [{card}]; {n_back} of {len(got)} tensors "
              f"bit-equal, plain tensors {not any(isinstance(t, DTensor) for _, t in back)}")
        check(step == tr.step and n_back == len(got) and not any(
            isinstance(t, DTensor) for _, t in back),
            "tensor-parallel: the mesh's save does not restore bit-equal on one device")
        del restored, back, got, want, tr, ref
        shutil.rmtree(directory, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        # -- serving: the one-device Server against one on the mesh
        cfg = ServeJobConfig.from_job({"payload": dict(SERVE, arch=TRAIN["arch"])})
        n, plen, new = SERVE["n_requests"], SERVE["prompt_len"], SERVE["max_new"]

        def serve(srv) -> list:
            vocab = srv.arch_cfg.vocab_size
            ids = [srv.submit([(i + j) % vocab for j in range(plen)], max_new=new)
                   for i in range(n)]
            srv.run()
            return [srv.requests[i].generated for i in ids]

        plain = Server(cfg)
        t0 = time.perf_counter()
        want_toks = serve(plain)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        meshed = Server(cfg, params=plain.params, mesh=mesh)
        check(isinstance(meshed.params["embed"], DTensor) and isinstance(
            meshed.cache["pos"], DTensor), "tensor-parallel: the Server on the mesh holds "
              "plain tensors")
        torch.cuda.synchronize()
        wrappers = reset_launches()
        t0 = time.perf_counter()
        got_toks = serve(meshed)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        served = {name: fn.launches for name, fn in wrappers.items()}
        print(f"tensor-parallel: a Server on the mesh, {n} requests of {plen} + {new} tokens, "
              f"{meshed.steps} decode steps: {mesh_s:.2f} s, one device {plain_s:.2f} s "
              f"[{card}]; greedy tokens equal the one-device Server's: {got_toks == want_toks}; "
              f"launches {served}")
        check(got_toks == want_toks and meshed.steps == plain.steps,
              "tensor-parallel: the Server on the mesh emits other tokens than one device's")
        for name, got_n in served.items():
            pre, dec = PATHS[0]["launches"].get(name, (0, 0))
            want_n = pre * n + dec * meshed.steps
            check(got_n == want_n, f"tensor-parallel: serve: {name} launched {got_n}, "
                  f"want {want_n}")
            launches[name] += got_n
        del plain, meshed
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tensor-parallel: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


def ssm_tp_per_step(arch: str, split: bool) -> dict:
    """Kernel launches in each train step of ``arch`` at SSM_TP_LAYERS: its
    gated norms through the one-launch entries, or (``split``) through the
    split-row entries, one launch each a layer both ways."""
    L = SSM_TP_LAYERS[arch]
    per = ssm_per_step(L) if arch == "mamba2-2.7b" else hybrid_per_step(L, 6)
    if split:
        fwd, bwd = per.pop("gated_rmsnorm"), per.pop("gated_rmsnorm_bwd")
        per.update(gated_rmsnorm_stats=fwd, gated_rmsnorm_split=fwd,
                   gated_rmsnorm_split_dot=bwd, gated_rmsnorm_split_bwd=bwd)
    return per


def ssm_serve_launches(arch: str, layers: int, split: bool) -> dict:
    """Kernel launches (a prefill, a decode step) of ``arch`` served at ``layers``
    (PATHS' tables at another depth); ``split``: the gated norm through the
    split-row forward entries."""
    G = layers // 6 if arch == "zamba2-7b" else 0
    per = {"ssd_scan": (layers, 0), "rmsnorm": (1, 1),
           "add_rmsnorm": ((layers - 1 + 2 * G + 1,) * 2 if G else (layers, layers)),
           "gated_rmsnorm": (layers, layers)}
    if G:
        per["flash_attention"] = (G, 0)
    if split:
        per["gated_rmsnorm_stats"] = per["gated_rmsnorm_split"] = per.pop("gated_rmsnorm")
    return per


def ssm_tp_forced(model, params) -> torch.Tensor:
    """The teacher-forced logits of SSM_TP_PROMPTS[0]'s prompt: its prefill's last
    position, then SSM_TP_DECODE decode steps of fixed tokens, [1 + steps, V] f32 on
    the CPU (a DTensor's gathered)."""
    from repro_torch.parallel.sharding import full_value
    prompt = SSM_TP_PROMPTS[0][0]
    with torch.no_grad():
        toks = torch.tensor([prompt], dtype=torch.long, device="cuda")
        logits, cache = model.prefill(params, {"tokens": toks}, max_len=SSM_TP_SERVE["max_len"])
        out = [full_value(logits)[0].float().cpu()]
        for i in range(SSM_TP_DECODE):
            step = torch.tensor([[prompt[i]]], dtype=torch.long, device="cuda")
            logits, cache = model.decode_step(params, step, cache)
            out.append(full_value(logits)[0].float().cpu())
    return torch.stack(out)


def ssm_tp_serve(srv) -> list:
    ids = [srv.submit(list(p), max_new=n) for p, n in SSM_TP_PROMPTS]
    srv.run()
    return [srv.requests[i].generated for i in ids]


def _ssm_tp_rank(rank: int, world: int, tmp: str) -> None:
    """One of two gloo ranks on the one card, a (1, 2) ("data", "model") mesh: for
    each arch of SSM_TP_LAYERS at that depth, a Trainer's SSM_TP_STEPS steps, a
    Server's SSM_TP_PROMPTS and the teacher-forced logits; each rank's launches of
    the steps and of the serve, counted from 0 just before each. Writes its report
    to ``tmp``."""
    import datetime
    import pickle
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.runtime.serve_loop import Server, ServeJobConfig
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    report = {}
    try:
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        for arch, layers in SSM_TP_LAYERS.items():
            with arch_depth(arch, layers):
                job = TrainJobConfig.from_job({"payload": dict(SSM_TP_TRAIN, arch=arch)})
                tr = Trainer(job, mesh=mesh)
                torch.cuda.synchronize()
                wrappers = reset_launches()
                walls = []
                for _ in range(SSM_TP_STEPS):
                    t0 = time.perf_counter()
                    tr.step_once()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                train = {name: fn.launches for name, fn in wrappers.items()}
                rep = {"train": train, "walls": walls, "split": tr.model.tp.ssm,
                       "series": {k: tr.metrics.series(k) for k in ("loss", "grad_norm")}}
                del tr
                gc.collect()
                torch.cuda.empty_cache()
                srv = Server(ServeJobConfig.from_job({"payload": dict(SSM_TP_SERVE, arch=arch)}),
                             mesh=mesh)
                wrappers = reset_launches()
                rep["tokens"] = ssm_tp_serve(srv)
                rep["serve"] = {name: fn.launches for name, fn in wrappers.items()}
                rep["steps"] = srv.steps
                rep["forced"] = ssm_tp_forced(srv.model, srv.params)
                del srv
                gc.collect()
                torch.cuda.empty_cache()
                report[arch] = rep
    finally:
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(report, f)
        dist.destroy_process_group()


def run_two_ranks(timeout_s: float, rank_fn=None) -> list:
    """``rank_fn`` (default ``_ssm_tp_rank``) on two spawned processes; returns
    their reports. Every process is stopped before it returns."""
    import pickle
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ctx = mp.start_processes(rank_fn or _ssm_tp_rank, args=(2, tmp), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"the two ranks did not finish in {timeout_s:.0f} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        reports = []
        for rank in range(2):
            with open(Path(tmp) / f"rank{rank}.pkl", "rb") as f:
                reports.append(pickle.load(f))
    return reports


def phase_ssm_tensor_parallel(card: str) -> dict:
    """The ssm and hybrid families' tensor-parallel code on the card.

    (b) A one-rank NCCL ("data", "model") mesh, every axis of size 1 (no collective
    runs): for mamba2-2.7b and zamba2-7b at full width and SSM_TP_LAYERS, a
    Trainer on the mesh (its state DTensors) takes SSM_TP_STEPS steps of one
    2,048-token sequence from seed 0, its losses, grad norms and every state tensor
    bit-equal to the one-device Trainer's, the kernels launched exactly
    ``ssm_tp_per_step`` a step (the one-launch gated entries); a mamba2-2.7b Server
    at full depth on the mesh serves SSM_TP_PROMPTS with the one-device Server's
    tokens, launches exact.
    (c) Two gloo ranks on the one card as a (1, 2) mesh (``run_two_ranks``): the
    same Trainers, whose mamba2 layers split d_inner and the heads 2 ways and run
    the gated norm through the split-row entries, and a short serve: losses and
    grad norms within SSM_TP_LOSS_TOL of the one-device Trainer's, the
    teacher-forced prefill and decode logits within SSM_TP_LOGIT_TOL of one
    device's, every kernel's launches exact on both ranks.
    Returns each path's launches (c's: rank 0's)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import OneDeviceMesh, full_value
    from repro_torch.runtime.serve_loop import Server, ServeJobConfig
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
    from repro_torch.tree import tree_flatten_sorted

    t_phase = time.perf_counter()
    # the one-device runs' mesh, given explicitly: with a process group up, the
    # default mesh is one over its ranks
    one_mesh = OneDeviceMesh(torch.device("cuda"))

    def steps(tr) -> list:
        walls = []
        for _ in range(SSM_TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.step_once()
            torch.cuda.synchronize()
            walls.append(round((time.perf_counter() - t0) * 1e3, 3))
        return walls

    def series(tr) -> dict:
        return {k: tr.metrics.series(k) for k in ("loss", "grad_norm")}

    def same_bits(a, b) -> int:
        a, b = list(tree_flatten_sorted(a)), list(tree_flatten_sorted(b))
        return sum(p == q and full_value(x).dtype == y.dtype and torch.equal(full_value(x), y)
                   for (p, x), (q, y) in zip(a, b)), len(b)

    ref, by_path = {}, {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        for arch, layers in SSM_TP_LAYERS.items():
            with arch_depth(arch, layers):
                job = TrainJobConfig.from_job({"payload": dict(SSM_TP_TRAIN, arch=arch)})
                one = Trainer(job, mesh=one_mesh)
                one_ms = steps(one)
                tr = Trainer(job, mesh=mesh)
                check(tr.model.ranked and all(isinstance(t, DTensor) for _, t in
                                              tree_flatten_sorted(tr.state)),
                      f"{arch} one-rank mesh: the Trainer's state is not DTensors")
                torch.cuda.synchronize()
                wrappers = reset_launches()
                mesh_ms = steps(tr)
                launches = {name: fn.launches for name, fn in wrappers.items()}
                n_same, n = same_bits(tr.state, one.state)
                ref[arch] = {"series": series(one), "ms": one_ms}
                print(f"ssm tensor-parallel: {arch} full width, {layers} layers, "
                      f"{SSM_TP_TRAIN['seq_len']} tokens a step, on a one-rank NCCL (1, 1) mesh:"
                      f" step ms {mesh_ms}, one device {one_ms} [{card}]; {series(tr)}, one "
                      f"device {series(one)}; {n_same} of {n} state tensors bit-equal; launches "
                      f"{launches}")
                check(series(tr) == series(one), f"{arch} one-rank mesh: {series(tr)} != one "
                      f"device's {series(one)}")
                check(n_same == n, f"{arch} one-rank mesh: {n - n_same} state tensors differ")
                per = ssm_tp_per_step(arch, split=False)
                for name, got in launches.items():
                    check(got == per.get(name, 0) * SSM_TP_STEPS,
                          f"{arch} one-rank mesh: {name} launched {got}, want "
                          f"{per.get(name, 0) * SSM_TP_STEPS}")
                del tr, one
                gc.collect()
                torch.cuda.empty_cache()
                srv = Server(ServeJobConfig.from_job({"payload": dict(SSM_TP_SERVE, arch=arch)}),
                             mesh=one_mesh)
                ref[arch]["tokens"] = ssm_tp_serve(srv)
                ref[arch]["forced"] = ssm_tp_forced(srv.model, srv.params)
                del srv
            by_path[SSM_TP_PATH[arch]] = launches
        # mamba2-2.7b served at full depth, on the mesh and on one device
        arch = "mamba2-2.7b"
        cfg = ServeJobConfig.from_job({"payload": dict(SSM_TP_SERVE, arch=arch)})
        plain = Server(cfg, mesh=one_mesh)
        want = ssm_tp_serve(plain)
        meshed = Server(cfg, params=plain.params, mesh=mesh)
        check(isinstance(meshed.params["embed"], DTensor) and isinstance(
            meshed.cache["layers"]["conv"], DTensor), f"{arch} one-rank mesh: the Server holds "
              "plain tensors")
        torch.cuda.synchronize()
        wrappers = reset_launches()
        t0 = time.perf_counter()
        got = ssm_tp_serve(meshed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        served = {name: fn.launches for name, fn in wrappers.items()}
        layers = meshed.arch_cfg.num_layers
        print(f"ssm tensor-parallel: a {arch} Server at full depth ({layers} layers) on the "
              f"mesh, {len(SSM_TP_PROMPTS)} requests, {meshed.steps} decode steps: {wall:.2f} s "
              f"[{card}]; tokens equal the one-device Server's: {got == want}; launches {served}")
        check(got == want and meshed.steps == plain.steps,
              f"{arch} one-rank mesh: the Server emits other tokens than one device's")
        per = ssm_serve_launches(arch, layers, split=False)
        for name, n in served.items():
            pre, dec = per.get(name, (0, 0))
            check(n == pre * len(SSM_TP_PROMPTS) + dec * meshed.steps,
                  f"{arch} one-rank mesh serve: {name} launched {n}")
            by_path[SSM_TP_PATH[arch]][name] += n
        del plain, meshed
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_phase

    # (c) two gloo ranks on the one card, a (1, 2) mesh
    t0 = time.perf_counter()
    reports = run_two_ranks(300)
    ranks_s = time.perf_counter() - t0
    for arch, layers in SSM_TP_LAYERS.items():
        want = ref[arch]
        r0 = reports[0][arch]
        for rank, rep in enumerate(reports):
            got = rep[arch]
            check(got["split"], f"{arch} (1, 2): rank {rank}'s mamba2 blocks are not split")
            for key in ("loss", "grad_norm"):
                a, b = torch.tensor(got["series"][key]), torch.tensor(want["series"][key])
                check(len(a) == SSM_TP_STEPS and close(a, b, SSM_TP_LOSS_TOL),
                      f"{arch} (1, 2) rank {rank}: {key} {a.tolist()} not within "
                      f"{SSM_TP_LOSS_TOL} of one device's {b.tolist()}")
            per = ssm_tp_per_step(arch, split=True)
            for name, n in got["train"].items():
                check(n == per.get(name, 0) * SSM_TP_STEPS, f"{arch} (1, 2) rank {rank}: "
                      f"{name} launched {n} in the steps, want {per.get(name, 0) * SSM_TP_STEPS}")
            per = ssm_serve_launches(arch, layers, split=True)
            for name, n in got["serve"].items():
                pre, dec = per.get(name, (0, 0))
                check(n == pre * len(SSM_TP_PROMPTS) + dec * got["steps"],
                      f"{arch} (1, 2) rank {rank}: {name} launched {n} in the serve")
            check(got["tokens"] == r0["tokens"], f"{arch} (1, 2): the ranks' tokens differ")
        forced = r0["forced"]
        check(close(forced, want["forced"], SSM_TP_LOGIT_TOL),
              f"{arch} (1, 2): teacher-forced logits max err {max_err(forced, want['forced'])}")
        agree = sum(a == b for g, w in zip(r0["tokens"], want["tokens"]) for a, b in zip(g, w))
        total = sum(len(w) for w in want["tokens"])
        print(f"ssm tensor-parallel (1, 2): {arch} full width, {layers} layers, two gloo ranks "
              f"on the one card: step ms {[round(t, 1) for t in r0['walls']]} (one device "
              f"{want['ms']}) [{card}]; losses {r0['series']['loss']}, one device "
              f"{want['series']['loss']}; grad norms {r0['series']['grad_norm']}, one device "
              f"{want['series']['grad_norm']}; teacher-forced logits max err "
              f"{max_err(forced, want['forced']):.4f} (gate {SSM_TP_LOGIT_TOL}); served tokens "
              f"equal to one device's {agree} of {total}; launches: steps {r0['train']}, serve "
              f"{r0['serve']}")
        by_path[SSM_TP2_PATH[arch]] = {name: r0["train"][name] + r0["serve"][name]
                                       for name in r0["train"]}
    print(f"ssm tensor-parallel: phase {time.perf_counter() - t_phase:.1f} s (one-rank mesh "
          f"{t_one:.1f} s, two ranks {ranks_s:.1f} s) [{card}]")
    return by_path


def forced_per_call(arch: str, layers) -> dict:
    """Kernel launches (a prefill, a decode step) of ``arch`` at ``layers`` decoder
    layers (None: every one): PATHS' tables at another depth (whisper: each
    encoder layer's and each decoder layer's self- and cross-attention, ln1 of both
    stacks' layer 0, every other norm with its add; llama-vision and the moe archs:
    one attention a layer, ln1 of layer 0, two norms a layer but the first's ln1,
    and the final norm, and qk-norm once a layer where the arch has it)."""
    from repro_torch import configs
    cfg = configs.get(arch)
    L = layers or cfg.num_layers
    if cfg.family == "encdec":
        enc = cfg.encoder_layers
        return {"flash_attention": (enc + 2 * L, 0), "rmsnorm": (2, 1),
                "add_rmsnorm": (2 * enc + 3 * L, 3 * L)}
    per = {"flash_attention": (L, 0), "rmsnorm": (1, 1), "add_rmsnorm": (2 * L, 2 * L)}
    if cfg.qk_norm:
        per["qk_norm_rope"] = (L, L)
    return per


def xattn_model(arch: str, dtype: str, layers, mesh=None):
    """(model, params) of ``arch`` at full width, ``layers`` decoder layers (None:
    every one) and ``dtype``, random from seed 0 with every gate at CROSS_GATE, on
    one device or (``mesh``) laid out on ``mesh`` by ``param_specs``."""
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import MeshPlan, distribute
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(configs.get(arch), remat="none", dtype=dtype)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if mesh is None:
        model = Model(cfg, "cuda")
        return model, with_gates(model.init_params(0))
    model = Model(cfg, "cuda", MeshPlan(mesh=mesh, fsdp=False))
    params = tree_map(lambda x, s: distribute(x, mesh, s), with_gates(model.init_params(0)),
                      model.param_specs())
    return model, params


def xattn_forced(model, params) -> torch.Tensor:
    """Teacher-forced logits of XATTN_TP_PROMPT on random frames or patches (from
    XATTN_TP_SEED): its prefill's last position, then XATTN_TP_DECODE decode steps
    of fixed tokens, [1 + steps, V] f32 on the CPU (a DTensor's gathered)."""
    from repro_torch.parallel.sharding import full_value
    gen = torch.Generator(device="cuda")
    gen.manual_seed(XATTN_TP_SEED)
    aux = aux_inputs(model.cfg, 1, gen)
    prompt = XATTN_TP_PROMPT
    with torch.no_grad():
        toks = torch.tensor([prompt], dtype=torch.long, device="cuda")
        logits, cache = model.prefill(params, {"tokens": toks, **aux},
                                      max_len=len(prompt) + XATTN_TP_DECODE)
        out = [full_value(logits)[0].float().cpu()]
        for i in range(XATTN_TP_DECODE):
            step = torch.tensor([[prompt[i]]], dtype=torch.long, device="cuda")
            logits, cache = model.decode_step(params, step, cache)
            out.append(full_value(logits)[0].float().cpu())
    return torch.stack(out)


def counted_forced(model, params) -> tuple:
    """(``xattn_forced``'s teacher-forced logits of ``model``, each kernel's
    launches in them, counted from 0 just before)."""
    torch.cuda.synchronize()
    wrappers = reset_launches()
    forced = xattn_forced(model, params)
    return forced, {name: fn.launches for name, fn in wrappers.items()}


def xattn_tp_trainer(mesh):
    """The phase's whisper-medium Trainer (XATTN_TP_TRAIN at XATTN_TP_TRAIN_LAYERS +
    XATTN_TP_TRAIN_LAYERS) on ``mesh``."""
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
    arch = XATTN_TP_TRAIN["arch"]
    with arch_depth(arch, XATTN_TP_TRAIN_LAYERS, XATTN_TP_TRAIN_LAYERS):
        return Trainer(TrainJobConfig.from_job({"payload": dict(XATTN_TP_TRAIN)}), mesh=mesh)


def xattn_tp_steps(tr, n: int = XATTN_TP_STEPS) -> tuple:
    """(each kernel's launches in ``n`` steps of ``tr``, their walls in ms)."""
    torch.cuda.synchronize()
    wrappers = reset_launches()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        tr.step_once()
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 3))
    return {name: fn.launches for name, fn in wrappers.items()}, walls


def xattn_tp_calls(mesh) -> list:
    """[(teacher-forced logits, each kernel's launches in them, whether the model
    splits the heads)] of XATTN_TP_CALLS on ``mesh``, each model freed after."""
    out = []
    for arch, dtype, layers, _ in XATTN_TP_CALLS:
        model, params = xattn_model(arch, dtype, layers, mesh)
        out.append(counted_forced(model, params) + (model.tp is not None and model.tp.heads,))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _xattn_tp_rank(rank: int, world: int, tmp: str) -> None:
    """One of two gloo ranks on the one card, a (1, 2) ("data", "model") mesh: the
    whisper Trainer's XATTN_TP_STEPS steps and both archs' teacher-forced calls,
    each rank's launches counted from 0 just before each. Writes its report to
    ``tmp``."""
    import datetime
    import pickle
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    report = {}
    try:
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        tr = xattn_tp_trainer(mesh)
        launches, walls = xattn_tp_steps(tr)
        report["train"] = {"launches": launches, "walls": walls,
                           "split": tr.model.tp is not None and tr.model.tp.heads,
                           "series": {k: tr.metrics.series(k) for k in ("loss", "grad_norm")}}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        report["calls"] = xattn_tp_calls(mesh)
    finally:
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(report, f)
        dist.destroy_process_group()


def phase_xattn_tensor_parallel(card: str) -> dict:
    """The encdec and vlm families' tensor-parallel code on the card.

    (b) A one-rank NCCL ("data", "model") mesh, every axis of size 1 (no collective
    runs): a whisper-medium Trainer at full width and XATTN_TP_TRAIN_LAYERS + as
    many layers on the mesh (its state DTensors) takes XATTN_TP_STEPS steps of one
    2,048-token sequence over the Trainer's 1,500 random frames, its losses, grad
    norms and every state tensor bit-equal to the one-device Trainer's, the kernels
    launched exactly ``encdec_per_step`` a step; the teacher-forced prefill and
    decode steps of XATTN_TP_CALLS (``xattn_forced``: random frames and patches,
    every gate at CROSS_GATE; the servers' zero frames would make every cross
    output 0; whisper-medium at full depth in bf16 and f32 and at 4 decoder
    layers, llama-3.2-vision-90b at 5 layers), on the mesh, bit-equal to one
    device's, launches exact.
    (c) Two gloo ranks on the one card as a (1, 2) mesh (``run_two_ranks``,
    ``_xattn_tp_rank``), whose layers split the heads 2 ways: the same Trainer,
    losses and grad norms within SSM_TP_LOSS_TOL of one device's; the same
    teacher-forced calls, logits within their XATTN_TP_CALLS gates of one
    device's; every kernel's launches exact on both ranks.
    Returns each path's launches (c's: rank 0's)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import OneDeviceMesh, full_value
    from repro_torch.tree import tree_flatten_sorted

    t_phase = time.perf_counter()
    arch = XATTN_TP_TRAIN["arch"]
    per_step = encdec_per_step(XATTN_TP_TRAIN_LAYERS, XATTN_TP_TRAIN_LAYERS)

    def series(tr) -> dict:
        return {k: tr.metrics.series(k) for k in ("loss", "grad_norm")}

    def check_launches(tag: str, launches: dict, want: dict, times: int = 1) -> None:
        for name, n in launches.items():
            check(n == want.get(name, 0) * times,
                  f"{tag}: {name} launched {n}, want {want.get(name, 0) * times}")

    def check_calls(call: tuple, tag: str, calls: dict) -> None:
        per = forced_per_call(call[0], call[2])
        for kernel, n in calls.items():
            pre, dec = per.get(kernel, (0, 0))
            check(n == pre + dec * XATTN_TP_DECODE, f"{named(call)} {tag}: {kernel} launched "
                  f"{n} in the prefill and {XATTN_TP_DECODE} decode steps, want "
                  f"{pre + dec * XATTN_TP_DECODE}")

    def named(call: tuple) -> str:
        arch_, dtype, layers, _ = call
        depth = f"{layers} layers" if layers else "full depth"
        return f"{arch_} ({'bf16' if dtype == 'bfloat16' else 'f32'}, {depth})"

    def add(path: str, calls: dict) -> None:
        into = by_path.setdefault(path, {})
        for k, n in calls.items():
            into[k] = into.get(k, 0) + n

    one_mesh = OneDeviceMesh(torch.device("cuda"))
    one = xattn_tp_trainer(one_mesh)
    _, one_ms = xattn_tp_steps(one)
    ref = {"series": series(one), "ms": one_ms}
    ref_state = [(p, t) for p, t in tree_flatten_sorted(one.state)]
    ref_calls = []
    for call in XATTN_TP_CALLS:
        model, params = xattn_model(*call[:3])
        ref_calls.append(xattn_forced(model, params))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    by_path = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        tr = xattn_tp_trainer(mesh)
        check(tr.model.ranked and all(isinstance(t, DTensor) for _, t in
                                      tree_flatten_sorted(tr.state)),
              f"{arch} one-rank mesh: the Trainer's state is not DTensors")
        launches, mesh_ms = xattn_tp_steps(tr)
        got = list(tree_flatten_sorted(tr.state))
        n_same = sum(p == q and full_value(x).dtype == y.dtype and torch.equal(full_value(x), y)
                     for (p, x), (q, y) in zip(got, ref_state))
        print(f"xattn tensor-parallel: {arch} full width, {XATTN_TP_TRAIN_LAYERS} + "
              f"{XATTN_TP_TRAIN_LAYERS} layers, {XATTN_TP_TRAIN['seq_len']} tokens over "
              f"1,500 frames a step, on a one-rank NCCL (1, 1) mesh: step ms {mesh_ms}, one "
              f"device {one_ms} [{card}]; {series(tr)}, one device {ref['series']}; {n_same} "
              f"of {len(ref_state)} state tensors bit-equal; launches {launches}")
        check(series(tr) == ref["series"], f"{arch} one-rank mesh: {series(tr)} != one "
              f"device's {ref['series']}")
        check(n_same == len(ref_state) == len(got),
              f"{arch} one-rank mesh: {len(ref_state) - n_same} state tensors differ")
        check_launches(f"{arch} one-rank mesh", launches, per_step, XATTN_TP_STEPS)
        by_path[XATTN_TP_PATH[arch]] = launches
        del tr, one, got, ref_state
        gc.collect()
        torch.cuda.empty_cache()
        for call, want, (forced, calls, _) in zip(XATTN_TP_CALLS, ref_calls,
                                                  xattn_tp_calls(mesh)):
            same = torch.equal(forced, want)
            print(f"xattn tensor-parallel: {named(call)} at full width, teacher-forced "
                  f"prefill of {len(XATTN_TP_PROMPT)} tokens and {XATTN_TP_DECODE} decode "
                  f"steps on random {'frames' if call[0] == arch else 'patches'} (gates "
                  f"{CROSS_GATE}) on the one-rank mesh: bit-equal to one device's {same} "
                  f"[{card}]; launches {calls}")
            check(same, f"{named(call)} one-rank mesh: the teacher-forced logits differ from "
                  f"one device's by {max_err(forced, want)}")
            check_calls(call, "one-rank mesh", calls)
            add(XATTN_TP_PATH[call[0]], calls)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_phase

    # (c) two gloo ranks on the one card, a (1, 2) mesh
    t0 = time.perf_counter()
    reports = run_two_ranks(300, _xattn_tp_rank)
    ranks_s = time.perf_counter() - t0
    r0 = reports[0]
    for rank, rep in enumerate(reports):
        got = rep["train"]
        check(got["split"], f"{arch} (1, 2): rank {rank}'s heads are not split")
        for key in ("loss", "grad_norm"):
            a, b = torch.tensor(got["series"][key]), torch.tensor(ref["series"][key])
            check(len(a) == XATTN_TP_STEPS and close(a, b, SSM_TP_LOSS_TOL),
                  f"{arch} (1, 2) rank {rank}: {key} {a.tolist()} not within "
                  f"{SSM_TP_LOSS_TOL} of one device's {b.tolist()}")
        check_launches(f"{arch} (1, 2) rank {rank}", got["launches"], per_step, XATTN_TP_STEPS)
        for call, (forced, calls, split), first in zip(XATTN_TP_CALLS, rep["calls"],
                                                       r0["calls"]):
            check(split, f"{named(call)} (1, 2): rank {rank}'s heads are not split")
            check(torch.equal(forced, first[0]), f"{named(call)} (1, 2): the ranks' logits differ")
            check_calls(call, f"(1, 2) rank {rank}", calls)
    train = r0["train"]
    print(f"xattn tensor-parallel (1, 2): {arch} full width, {XATTN_TP_TRAIN_LAYERS} + "
          f"{XATTN_TP_TRAIN_LAYERS} layers, two gloo ranks on the one card: step ms "
          f"{[round(t, 1) for t in train['walls']]} (one device {ref['ms']}) [{card}]; losses "
          f"{train['series']['loss']}, one device {ref['series']['loss']}; grad norms "
          f"{train['series']['grad_norm']}, one device {ref['series']['grad_norm']}; launches "
          f"{train['launches']}")
    by_path[XATTN_TP2_PATH[arch]] = dict(train["launches"])
    for call, want, (forced, calls, _) in zip(XATTN_TP_CALLS, ref_calls, r0["calls"]):
        err, gate = max_err(forced, want), call[3]
        steps = [round(max_err(a, b), 4) for a, b in zip(forced, want)]
        print(f"xattn tensor-parallel (1, 2): {named(call)} teacher-forced logits max err "
              f"{err:.4g} (prefill, then each decode step: {steps}; |logit| max "
              f"{want.abs().max().item():.3g}; gate "
              f"{f'{gate} + {gate}|x|' if gate else 'none, printed'}) [{card}]; launches "
              f"{calls}")
        if gate:
            check(close(forced, want, gate), f"{named(call)} (1, 2): teacher-forced logits "
                  f"max err {err}")
        add(XATTN_TP2_PATH[call[0]], calls)
    print(f"xattn tensor-parallel: phase {time.perf_counter() - t_phase:.1f} s (one device and "
          f"the one-rank mesh {t_one:.1f} s, two ranks {ranks_s:.1f} s) [{card}]")
    return by_path


def moe_tp_trainer(mesh):
    """The phase's deepseek-moe-16b Trainer (MOE_TP_TRAIN at MOE_TP_TRAIN_LAYERS) on
    ``mesh``."""
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
    with arch_depth(MOE_TP_TRAIN["arch"], MOE_TP_TRAIN_LAYERS):
        return Trainer(TrainJobConfig.from_job({"payload": dict(MOE_TP_TRAIN)}), mesh=mesh)


def local_experts(model) -> int:
    """The experts of a layer that this rank holds and computes."""
    E = model.cfg.num_experts
    return model.tp.expert_range(E)[1] if model.tp is not None else E


def _moe_tp_rank(rank: int, world: int, tmp: str) -> None:
    """One of two gloo ranks on the one card, a (1, 2) ("data", "model") mesh: the
    deepseek-moe Trainer's MOE_TP_STEPS steps and the teacher-forced calls of
    MOE_TP_CALLS, each rank's launches counted from 0 just before each. Writes its
    report to ``tmp``."""
    import datetime
    import pickle
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    report = {}
    try:
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        tr = moe_tp_trainer(mesh)
        launches, walls = xattn_tp_steps(tr, MOE_TP_STEPS)
        report["train"] = {"launches": launches, "walls": walls,
                           "experts": local_experts(tr.model),
                           "series": {k: tr.metrics.series(k) for k in ("loss", "grad_norm")}}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        report["calls"] = []
        for arch, layers in MOE_TP_CALLS:
            model, params = xattn_model(arch, "bfloat16", layers, mesh)
            report["calls"].append(counted_forced(model, params) + (local_experts(model),))
            del model, params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(report, f)
        dist.destroy_process_group()


def phase_moe_tensor_parallel(card: str) -> dict:
    """The moe family's expert parallelism on the card.

    (b) A one-rank NCCL ("data", "model") mesh, every axis of size 1 (no collective
    runs): a deepseek-moe-16b Trainer at full width and MOE_TP_TRAIN_LAYERS on the
    mesh (its state DTensors) takes MOE_TP_STEPS steps of one 2,048-token sequence
    at capacity 1.25, its losses, grad norms and every state tensor bit-equal to a
    one-device Trainer's, both with PyTorch's deterministic algorithms on (the
    dispatch gather's backward otherwise adds each token's K slot gradients with
    atomics, in no fixed order); a one-device run with them off gives the spread
    that atomics leave, printed, which the mesh run lies within; the kernels
    launched exactly ``dense_per_step`` a step. The teacher-forced prefill and
    decode steps of MOE_TP_CALLS (deepseek-moe-16b at 4 layers, qwen3-moe-235b-a22b
    at 2, bf16, full width, capacity 1.25) on the mesh, bit-equal to one device's,
    launches exact.
    (c) Two gloo ranks on the one card as a (1, 2) mesh (``run_two_ranks``,
    ``_moe_tp_rank``), each holding half of every layer's experts: the same
    Trainer, losses within MOE_TP_LOSS_TOL and grad norms within MOE_TP_NORM_TOL
    of one device's; the same teacher-forced calls, logits within
    SSM_TP_LOGIT_TOL of one device's; every kernel's launches exact on both
    ranks; the warm step beside one device's.
    Returns each path's launches (c's: rank 0's)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import MeshPlan, OneDeviceMesh, distribute, full_value
    from repro_torch.tree import tree_flatten_sorted, tree_map

    t_phase = time.perf_counter()
    arch = MOE_TP_TRAIN["arch"]
    per_step = dense_per_step(MOE_TP_TRAIN_LAYERS, qk_norm=False)
    one_mesh = OneDeviceMesh(torch.device("cuda"))

    def series(tr) -> dict:
        return {k: tr.metrics.series(k) for k in ("loss", "grad_norm")}

    def check_launches(tag: str, launches: dict, want: dict, times: int = 1) -> None:
        for name, n in launches.items():
            check(n == want.get(name, 0) * times,
                  f"{tag}: {name} launched {n}, want {want.get(name, 0) * times}")

    def check_calls(call: tuple, tag: str, calls: dict) -> None:
        per = forced_per_call(*call)
        for kernel, n in calls.items():
            pre, dec = per.get(kernel, (0, 0))
            check(n == pre + dec * XATTN_TP_DECODE, f"{call[0]} ({call[1]} layers) {tag}: "
                  f"{kernel} launched {n} in the prefill and {XATTN_TP_DECODE} decode steps, "
                  f"want {pre + dec * XATTN_TP_DECODE}")

    def deterministic(tr) -> tuple:
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            return xattn_tp_steps(tr, MOE_TP_STEPS)
        finally:
            torch.use_deterministic_algorithms(was)

    # one device: a Trainer with deterministic algorithms, then again without
    one = moe_tp_trainer(one_mesh)
    _, det_ms = deterministic(one)
    det = series(one)
    ref_state = list(tree_flatten_sorted(one.state))
    one.rebind(one.cfg)
    _, one_ms = xattn_tp_steps(one, MOE_TP_STEPS)
    ref = {"series": series(one), "ms": one_ms}
    del one
    gc.collect()
    torch.cuda.empty_cache()
    spread = {k: max(abs(a - b) for a, b in zip(det[k], ref["series"][k])) for k in det}
    by_path, ref_calls = {}, []
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        tr = moe_tp_trainer(mesh)
        check(tr.model.ranked and all(isinstance(t, DTensor) for _, t in
                                      tree_flatten_sorted(tr.state)),
              f"{arch} one-rank mesh: the Trainer's state is not DTensors")
        launches, mesh_ms = deterministic(tr)
        got = list(tree_flatten_sorted(tr.state))
        n_same = sum(p == q and full_value(x).dtype == y.dtype and torch.equal(full_value(x), y)
                     for (p, x), (q, y) in zip(got, ref_state))
        print(f"moe expert-parallel: {arch} full width, {MOE_TP_TRAIN_LAYERS} layers, "
              f"{MOE_TP_TRAIN['seq_len']} tokens a step at capacity 1.25, deterministic "
              f"algorithms, on a one-rank NCCL (1, 1) mesh: step ms {mesh_ms}, one device "
              f"{det_ms} [{card}]; {series(tr)}, one device {det}; {n_same} of "
              f"{len(ref_state)} state tensors bit-equal; a one-device run without "
              f"deterministic algorithms {ref['series']} (step ms {one_ms}), spread {spread}; "
              f"launches {launches}")
        check(series(tr) == det, f"{arch} one-rank mesh: {series(tr)} != one device's {det}")
        check(n_same == len(ref_state) == len(got),
              f"{arch} one-rank mesh: {len(ref_state) - n_same} state tensors differ")
        check_launches(f"{arch} one-rank mesh", launches, per_step, MOE_TP_STEPS)
        by_path[MOE_TP_PATH[arch]] = launches
        del tr, got, ref_state
        gc.collect()
        torch.cuda.empty_cache()
        for call in MOE_TP_CALLS:
            model, params = xattn_model(call[0], "bfloat16", call[1])
            want, _ = counted_forced(model, params)
            meshed = Model(model.cfg, "cuda", MeshPlan(mesh=mesh, fsdp=False))
            dparams = tree_map(lambda x, sp: distribute(x, mesh, sp), params,
                               meshed.param_specs())
            forced, calls = counted_forced(meshed, dparams)
            same = torch.equal(forced, want)
            print(f"moe expert-parallel: {call[0]} (bf16, {call[1]} layers) at full width, "
                  f"teacher-forced prefill of {len(XATTN_TP_PROMPT)} tokens and "
                  f"{XATTN_TP_DECODE} decode steps on the one-rank mesh: bit-equal to one "
                  f"device's {same} [{card}]; launches {calls}")
            check(same, f"{call[0]} one-rank mesh: the teacher-forced logits differ from one "
                  f"device's by {max_err(forced, want)}")
            check_calls(call, "one-rank mesh", calls)
            by_path[MOE_TP_PATH[call[0]]] = {
                k: by_path.get(MOE_TP_PATH[call[0]], {}).get(k, 0) + n for k, n in calls.items()}
            ref_calls.append(want)
            del model, params, meshed, dparams
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_phase

    # (c) two gloo ranks on the one card, a (1, 2) mesh
    t0 = time.perf_counter()
    reports = run_two_ranks(300, _moe_tp_rank)
    ranks_s = time.perf_counter() - t0
    r0 = reports[0]
    for rank, rep in enumerate(reports):
        got = rep["train"]
        check(got["experts"] == 32, f"{arch} (1, 2): rank {rank} holds {got['experts']} experts "
              "a layer, not 32 of 64")
        a, b = torch.tensor(got["series"]["loss"]), torch.tensor(ref["series"]["loss"])
        check(len(a) == MOE_TP_STEPS and bool(((a - b).abs() <= MOE_TP_LOSS_TOL).all()),
              f"{arch} (1, 2) rank {rank}: losses {a.tolist()} not within {MOE_TP_LOSS_TOL} "
              f"of one device's {b.tolist()}")
        a, b = torch.tensor(got["series"]["grad_norm"]), torch.tensor(ref["series"]["grad_norm"])
        check(len(a) == MOE_TP_STEPS and close(a, b, MOE_TP_NORM_TOL),
              f"{arch} (1, 2) rank {rank}: grad norms {a.tolist()} not within "
              f"{MOE_TP_NORM_TOL} + {MOE_TP_NORM_TOL}|x| of one device's {b.tolist()}")
        check_launches(f"{arch} (1, 2) rank {rank}", got["launches"], per_step, MOE_TP_STEPS)
        for call, (forced, calls, experts), first in zip(MOE_TP_CALLS, rep["calls"], r0["calls"]):
            E = 64 if call[0] == arch else 128
            check(experts * 2 == E, f"{call[0]} (1, 2): rank {rank} holds {experts} experts "
                  f"a layer, not {E // 2} of {E}")
            check(torch.equal(forced, first[0]), f"{call[0]} (1, 2): the ranks' logits differ")
            check_calls(call, f"(1, 2) rank {rank}", calls)
    train = r0["train"]
    print(f"moe expert-parallel (1, 2): {arch} full width, {MOE_TP_TRAIN_LAYERS} layers, two "
          f"gloo ranks on the one card, 32 of 64 experts each: step ms "
          f"{[round(t, 1) for t in train['walls']]}, warm {train['walls'][-1]:.1f} against one "
          f"device's {ref['ms'][-1]:.1f} [{card}]; losses {train['series']['loss']}, one device "
          f"{ref['series']['loss']}; grad norms {train['series']['grad_norm']}, one device "
          f"{ref['series']['grad_norm']}; launches {train['launches']}")
    by_path[MOE_TP2_PATH[arch]] = dict(train["launches"])
    for call, want, (forced, calls, experts) in zip(MOE_TP_CALLS, ref_calls, r0["calls"]):
        err = max_err(forced, want)
        steps = [round(max_err(a, b), 4) for a, b in zip(forced, want)]
        print(f"moe expert-parallel (1, 2): {call[0]} (bf16, {call[1]} layers, {experts} experts "
              f"a rank) teacher-forced logits max err {err:.4g} (prefill, then each decode step: "
              f"{steps}; |logit| max {want.abs().max().item():.3g}; gate {SSM_TP_LOGIT_TOL} + "
              f"{SSM_TP_LOGIT_TOL}|x|) [{card}]; launches {calls}")
        check(close(forced, want, SSM_TP_LOGIT_TOL), f"{call[0]} (1, 2): teacher-forced logits "
              f"max err {err}")
        into = by_path.setdefault(MOE_TP2_PATH[call[0]], {})
        for k, n in calls.items():
            into[k] = into.get(k, 0) + n
    print(f"moe expert-parallel: phase {time.perf_counter() - t_phase:.1f} s (one device and "
          f"the one-rank mesh {t_one:.1f} s, two ranks {ranks_s:.1f} s) [{card}]")
    return by_path


def bit_digest(t: torch.Tensor) -> tuple:
    """Two int64 sums of a tensor's raw words (plain, and weighted by position),
    wrapping: bit-equal tensors give equal digests."""
    words = {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    w = t.detach().contiguous().view(words).flatten()
    plain = weighted = 0
    for i, chunk in enumerate(w.split(1 << 26)):
        c = chunk.to(torch.int64)
        pos = torch.arange(c.numel(), device=c.device, dtype=torch.int64) + (i << 26)
        plain += int(c.sum())
        weighted += int((c * (pos % 65521 + 1)).sum())
    return str(t.dtype), tuple(t.shape), plain, weighted


def pod_digests(state, first: int = 0) -> dict:
    """{leaf path: {pod: digest}} of this rank's values of a local-SGD state: a
    stacked leaf's per local pod (numbered from ``first``), another's under pod
    None."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_flatten_sorted
    out = {}
    for path, t in tree_flatten_sorted(state):
        t = t.to_local() if isinstance(t, DTensor) else t
        if path[0] in ("pod_params", "pod_opt", "ef"):
            out[path] = {first + p: bit_digest(t[p]) for p in range(t.shape[0])}
        else:
            out[path] = {None: bit_digest(t)}
    return out


def local_sgd_pods_rounds(tr) -> tuple:
    """The Trainer's rounds of LOCAL_SGD_PODS, the launch counters set to 0 just
    before: (launches, each round's wall ms)."""
    H = LOCAL_SGD_PODS["local_sgd"]["inner_steps"]
    torch.cuda.synchronize()
    wrappers = reset_launches()
    walls = []
    for _ in range(LOCAL_SGD_PODS["steps"] // H):
        t0 = time.perf_counter()
        tr.step_once()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {name: fn.launches for name, fn in wrappers.items()}, walls


def _local_sgd_pods_rank(rank: int, world: int, tmp: str) -> None:
    """One of two gloo ranks on the one card, a (2, 1, 1) ("pod", "data", "model")
    mesh, pod ``rank`` on each: LOCAL_SGD_PODS's Trainer, its launches counted from 0
    just before its rounds, the bytes it sends over the "pod" group a round, and
    its local pod's digests. Writes its report to ``tmp``."""
    import datetime
    import pickle
    import traceback
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    report = {}
    try:
        mesh = init_device_mesh("cuda", (world, 1, 1), mesh_dim_names=POD_AXES)
        pod = mesh.get_group("pod")
        tr = Trainer(TrainJobConfig.from_job({"payload": dict(LOCAL_SGD_PODS)}), mesh=mesh)
        sent = {"calls": 0, "bytes": 0, "dtypes": set()}
        real = dist.all_gather

        def counted(parts, x, group=None, **kw):
            if group is pod:
                sent["calls"] += 1
                sent["bytes"] += x.numel() * x.element_size() * (world - 1)
                sent["dtypes"].add(str(x.dtype))
            return real(parts, x, group=group, **kw)

        dist.all_gather = counted
        try:
            launches, walls = local_sgd_pods_rounds(tr)
        finally:
            dist.all_gather = real
        rounds = len(walls)
        sent.update(calls=sent["calls"] / rounds, bytes=sent["bytes"] / rounds)
        report = {"launches": launches, "walls": walls, "sent": sent,
                  "delta_norm": tr.metrics.series("delta_norm"),
                  "local_pods": tr.state["pod_opt"]["step"].to_local().shape[0],
                  "digests": pod_digests(tr.state, first=rank)}
    except Exception:
        report["error"] = traceback.format_exc()[-2000:]
        raise
    finally:
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(report, f)
        dist.destroy_process_group()


def phase_local_sgd_pods(card: str) -> dict:
    """Local SGD with its pods on ranks of their own (``optim/local_sgd.py`` on a
    mesh with a "pod" axis), on the card.

    (a) A one-rank NCCL ("pod", "data", "model") mesh (1, 1, 1): a local-SGD
    Trainer of LOCAL_SGD_PODS (qwen3-0.6b at full width and depth, 2 pods, H = 2,
    2 rounds of 1 x 2048 tokens a pod and inner step), its state DTensors, every
    leaf bit-equal (per-leaf, per-pod bit digests) to the one-device local-SGD
    Trainer's, delta norms equal, K1 and K2 launched exactly 2 pods x H x 2 rounds
    of ``dense_per_step``.
    (b) Two gloo ranks sharing the card as a (2, 1, 1) mesh (``run_two_ranks``,
    ``_local_sgd_pods_rank``), one pod a rank: each rank's pod bit-equal to that
    pod of the one-device run, the global master and momentum bit-equal on both,
    the delta norms equal; each rank's K1 and K2 launches exactly half the one-device
    run's; the round's only collective over "pod" the all-gathers of each leaf's
    int8 values and f32 scales, whose bytes a rank sends in a round are printed
    beside ``dcn_bytes_per_round``'s figure (a ring all-reduce's 2x payload).
    The one-device run and (a) go in turn, never at once (30.8 GiB of state each);
    the ranks after both. Returns each path's launches ((b)'s: rank 0's)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.optim.local_sgd import dcn_bytes_per_round
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
    from repro_torch.tree import tree_flatten_sorted, tree_leaves

    t_phase = time.perf_counter()
    job = TrainJobConfig.from_job({"payload": dict(LOCAL_SGD_PODS)})
    P, H = job.n_pods, job.local_sgd.inner_steps
    rounds = job.steps // H
    per_step = dense_per_step(28)

    def held(tag: str, launches: dict, pods: int) -> None:
        for name, n in launches.items():
            want = per_step.get(name, 0) * pods * H * rounds
            check(n == want, f"local SGD pods {tag}: {name} launched {n}, want {want}")

    one = Trainer(job)
    check(one.arch_cfg.num_layers == 28, "local SGD pods: the depth is cut")
    one_launches, one_ms = local_sgd_pods_rounds(one)
    want = pod_digests(one.state)
    want_norms = one.metrics.series("delta_norm")
    payload, _ = dcn_bytes_per_round(one.state["master"], job.local_sgd)
    n_leaves = len(tree_leaves(one.state["master"]))
    state_gib = sum(t.numel() * t.element_size() for t in tree_leaves(one.state)) / 2**30
    held("one device", one_launches, P)
    del one
    gc.collect()
    torch.cuda.empty_cache()

    by_path = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=POD_AXES)
        tr = Trainer(job, mesh=mesh)
        check(tr.model.ranked and all(isinstance(t, DTensor) and t.device_mesh == mesh
                                      for _, t in tree_flatten_sorted(tr.state)),
              "local SGD pods: the Trainer's state on the one-rank mesh is not DTensors")
        launches, mesh_ms = local_sgd_pods_rounds(tr)
        got = pod_digests(tr.state)
        norms = tr.metrics.series("delta_norm")
        n_same = sum(got[p] == want[p] for p in want)
        print(f"local SGD pods: {job.arch} full width, 28 layers, bf16, {P} pods x H={H} x "
              f"{job.global_batch // P} x {job.seq_len} tokens, {rounds} rounds, on a one-rank "
              f"NCCL (1, 1, 1) ('pod', 'data', 'model') mesh: round ms "
              f"{[round(t, 1) for t in mesh_ms]}, one device {[round(t, 1) for t in one_ms]} "
              f"[{card}]; delta_norm {norms}, one device {want_norms}; {n_same} of "
              f"{len(want)} leaves bit-equal (per-pod digests; {state_gib:.2f} GiB of state); "
              f"launches {launches}")
        check(norms == want_norms, f"local SGD pods one-rank mesh: delta_norm {norms} != "
              f"one device's {want_norms}")
        check(n_same == len(want) == len(got),
              f"local SGD pods one-rank mesh: {len(want) - n_same} leaves differ from one "
              f"device's")
        held("one-rank mesh", launches, P)
        by_path[LOCAL_SGD_PODS_PATH] = launches
        del tr, got
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_phase

    # (b) two gloo ranks on the one card, a (2, 1, 1) mesh, one pod a rank
    t0 = time.perf_counter()
    reports = run_two_ranks(300, _local_sgd_pods_rank)
    ranks_s = time.perf_counter() - t0
    for rank, rep in enumerate(reports):
        check("error" not in rep, f"local SGD pods (2, 1, 1) rank {rank}: {rep.get('error')}")
        check(rep.get("local_pods") == 1, f"local SGD pods (2, 1, 1): rank {rank} holds "
              f"{rep.get('local_pods')} pods, not 1")
        digests = rep["digests"]
        bad = [path for path, by_pod in digests.items()
               if any(d != want[path][p] for p, d in by_pod.items())]
        check(digests.keys() == want.keys() and not bad,
              f"local SGD pods (2, 1, 1) rank {rank}: leaves differ from one device's: "
              f"{bad[:4]}")
        check(rep["delta_norm"] == want_norms, f"local SGD pods (2, 1, 1) rank {rank}: "
              f"delta_norm {rep['delta_norm']} != one device's {want_norms}")
        held(f"(2, 1, 1) rank {rank}", rep["launches"], 1)
        sent = rep["sent"]
        check(sent["calls"] == 2 * n_leaves and sent["dtypes"] == {"torch.int8", "torch.float32"},
              f"local SGD pods (2, 1, 1) rank {rank}: {sent['calls']:g} all-gathers over 'pod' "
              f"of {sorted(sent['dtypes'])} in a round, want {2 * n_leaves} of int8 and f32")
    r0 = reports[0]
    print(f"local SGD pods (2, 1, 1): two gloo ranks on the one card, one pod each: round ms "
          f"{[round(t, 1) for t in r0['walls']]} (rank 1 "
          f"{[round(t, 1) for t in reports[1]['walls']]}), one device "
          f"{[round(t, 1) for t in one_ms]} [{card}]; every leaf bit-equal to one device's "
          f"pod by pod; delta_norm {r0['delta_norm']}; a rank sent {r0['sent']['bytes']:,.0f} "
          f"bytes over 'pod' in a round ({r0['sent']['calls']:g} all-gathers: int8 values and "
          f"f32 scales), dcn_bytes_per_round {payload:,} (a ring all-reduce's 2x payload); "
          f"launches {r0['launches']}")
    by_path[LOCAL_SGD_PODS2_PATH] = dict(r0["launches"])
    MEASURED["pod_bytes_a_round"] = r0["sent"]["bytes"]
    print(f"local SGD pods: phase {time.perf_counter() - t_phase:.1f} s (one device and the "
          f"one-rank mesh {t_one:.1f} s, two ranks {ranks_s:.1f} s) [{card}]")
    return by_path


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

    # -- the port's examples, uncounted, at EXAMPLE_LAYERS
    with tempfile.TemporaryDirectory(dir=build) as ck, arch_depth("qwen3-0.6b", EXAMPLE_LAYERS):
        t0 = time.perf_counter()
        load_example("torch_quickstart").main(device="cuda", checkpoint_root=ck)
        torch.cuda.synchronize()
        walls["torch_quickstart"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build) as ck, arch_depth("qwen3-0.6b", EXAMPLE_LAYERS):
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
    # the backward kernels a step (the counters above hold the forward's launches):
    # K2's are a layer's gated_rmsnorm_bwd (GATED_BWD_KERNELS) and add_rmsnorm_bwd,
    # and layer 0's rmsnorm_bwd
    for label, want in (("K3 backward", 3 * layers),
                        ("K2 backward", (GATED_BWD_KERNELS + 1) * layers + 1)):
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
    want = sum(per_step.get(name, 0) for name in K2_BWD_ENTRIES) \
        + GATED_BWD_KERNELS * per_step.get("gated_rmsnorm_bwd", 0)
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
def arch_depth(arch: str, layers: int, encoder_layers: int = 0):
    """``configs.get(arch)`` with ``num_layers`` cut to ``layers`` (and an
    encoder's to ``encoder_layers``, where given; full width), for the tasks,
    which name an arch and build their config from the registry."""
    from repro_torch import configs
    real = configs.get
    depth = dict(num_layers=layers, **({"encoder_layers": encoder_layers}
                                      if encoder_layers else {}))

    def cut(name):
        cfg = real(name)
        return dataclasses.replace(cfg, **depth) if name == arch else cfg

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
    """whisper-medium's train task at full width, cut to WHISPER_TASK_LAYERS
    encoder and decoder layers, with a checkpoint (2 steps, a checkpoint every 2)
    and a strict eval-task restore of it: the launches exactly 2 steps' (the
    encoder's included), the restored state's eval loss on the Trainer's frames
    the trained state's own. (At full depth a save is ~14 GB; the path trains at
    full depth in ``phase_cut_train``.)"""
    from repro_torch.runtime.step_cache import TrainerCache, run_eval_task, run_train_task
    from repro_torch.runtime.train_loop import TrainJobConfig

    steps = 2
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    print(f"whisper task: {shutil.disk_usage(build).free / 2**30:.1f} GiB free for checkpoints")
    L = WHISPER_TASK_LAYERS
    with tempfile.TemporaryDirectory(dir=build) as ckdir, \
            arch_depth(WHISPER_TRAIN["arch"], L, encoder_layers=L):
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
        print(f"train task {WHISPER_TRAIN['arch']} full width, cut to "
              f"{trainer.arch_cfg.encoder_layers} + {trainer.arch_cfg.num_layers} layers, "
              f"checkpointed: {res} in {wall:.2f} s ({save_gb:.2f} GB a save); losses "
              f"{losses}; launches {launches}")
        check(res["steps"] == steps and res["ran_steps"] == steps and len(losses) == steps
              and all(math.isfinite(v) for v in losses), f"whisper train task: {res}")
        check(res["checkpoint"] == {"step": steps, "path": ckdir},
              f"whisper train task checkpoint {res.get('checkpoint')}")
        check({"params/enc_norm", "params/layers/xattn/wk"} <= set(manifest["leaves"]),
              f"whisper checkpoint leaves {sorted(manifest['leaves'])[:8]}")
        for name, per in encdec_per_step(L, L).items():
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
# The K1, K2 and K3 kernels whose SASS may differ from (here: be missing against)
# the other checkout's, each pattern with its reason: an older checkout's kernels
# that this one has replaced
SASS_REPLACED = [
    (re.compile(r"rows_bwd_kernelI(f|13__nv_bfloat16)Li\d+ELi2E"),
     "K2's gated backward in rows_bwd_kernel's third mode (MODE 2), redesigned as "
     "gated_bwd_kernel and gated_fold_kernel (both held within K2's gates, dy and dz "
     "bit-equal where each row's sums keep their order)"),
    (re.compile(r"gated_split_(sums|norm|bwd)_kernel"),
     "K2's split-row entries' first kernels, redesigned as split_rows_kernel (the three "
     "row passes, on rows_kernel's plan) and split_bwd_kernel (the backward's finish, "
     "on gated_bwd_kernel's; gated_fold_kernel unchanged), held within K2's gates by "
     "phase_split_norm and timed in turns against them below"),
]


def fold_scratch(blocks: int):
    """Another checkout's K2 backward scratch, as its wrappers give it: for each
    width W a zeroed f64 buffer of the tickets and fold_rows(blocks) rows of W.
    Returns W -> the buffer's address."""
    from repro_torch.kernels import rmsnorm as RN
    bufs = {}

    def ptr(W: int) -> int:
        if W not in bufs:
            bufs[W] = torch.zeros(RN._TICKETS + RN.fold_rows(blocks) * W,
                                  dtype=torch.float64, device="cuda")
        return bufs[W].data_ptr()
    return ptr


def other_gated_bwd(fn, scratch, blocks: int):
    """(y, z, scale, dout) -> (dy, dz, dscale) through another checkout's
    gated_rmsnorm_bwd entry ``fn``: ``blocks`` as its int and a fold_scratch of
    fold_rows(blocks) rows, which holds both designs' contracts (rows_bwd_kernel's
    gated mode folds through one row a block, at most ``blocks`` blocks, in one
    launch; gated_bwd_kernel writes one row a block, one block an SM and at most
    as many as the int, and gated_fold_kernel sums them)."""
    from repro_torch.kernels import rmsnorm as RN

    def call(y, z, sc, dout):
        D = y.shape[-1]
        dy, dz, dscale = torch.empty_like(y), torch.empty_like(z), torch.empty_like(sc)
        err = fn(y.data_ptr(), z.data_ptr(), sc.data_ptr(), dout.data_ptr(), dy.data_ptr(),
                 dz.data_ptr(), dscale.data_ptr(), scratch(D), blocks, y.numel() // D, D,
                 1e-6, RN._DTYPE_CODE[y.dtype], y.device.index,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the other checkout's gated_rmsnorm_bwd: cudaError {err}")
        return dy, dz, dscale
    return call


def gated_order_kept(D: int, dtype) -> bool:
    """Whether gated_bwd_kernel sums a row of D in rows_bwd_kernel's order: rows of
    up to 128 16-byte vectors go to the same lane groups; wider ones to teams of
    2 vectors a thread, where rows_bwd_kernel gave a thread 4 or 8."""
    return D * torch.finfo(dtype).bits // 8 <= 128 * 16


def gated_bwd_held(tag: str, mine, theirs, want, dtype) -> int:
    """This checkout's and the other's gated backward against the plain version
    (``want``; f32: gated_bwd_exact) within K2's gates, every output; this dy and
    dz against the other's bit for bit where each row's sums run in the same
    order (gated_order_kept, against a checkout whose gated backward was
    rows_bwd_kernel's mode); returns the elements of dy and dz that differ
    between the two."""
    for who, got in (("this", mine), ("other", theirs)):
        for i, (g, w) in enumerate(zip(got, want)):
            check(close(g, w, RMS_TOL[dtype]), f"{tag} {who} output {i}: max err "
                  f"{max_err(g, w)}")
    differ = sum(int((a != b).sum()) for a, b in zip(mine[:2], theirs[:2]))
    check(differ == 0 or not gated_order_kept(mine[0].shape[-1], dtype),
          f"{tag}: dy and dz differ from the other checkout's in {differ} elements, "
          "though each row's sums run in the same order")
    return differ


def other_rmsnorm(checkout: Path, lib):
    """The other checkout's kernels/rmsnorm.py loaded as a module of its own whose
    wrappers call ``lib`` (its rmsnorm.cu, from build_other): each checkout's
    split-row entries through its own wrappers, plans and scratch sizes. Its
    imports resolve to this checkout's package."""
    import importlib.util
    from repro_torch.kernels import rmsnorm as RN
    spec = importlib.util.spec_from_file_location(
        "other_rmsnorm", checkout.resolve() / "src" / "repro_torch" / "kernels" / "rmsnorm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mine = RN._lib()
    for fn in ("gated_rmsnorm_split_stats", "gated_rmsnorm_split_fwd", "gated_rmsnorm_split_dot",
               "gated_rmsnorm_split_bwd"):
        getattr(lib, fn).argtypes = getattr(mine, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    mod._lib = lambda: lib
    return mod


def split_entries(RN, a, b, c, g, ss, dot, width: int) -> dict:
    """SPLIT_NAMES -> a call of that entry of module RN on one local row block."""
    return {"gated_rmsnorm_stats": lambda: RN.gated_rmsnorm_stats_cuda(a, b),
            "gated_rmsnorm_split": lambda: RN.gated_rmsnorm_split_cuda(a, b, c, ss, width),
            "gated_rmsnorm_split_dot": lambda: RN.gated_rmsnorm_split_dot_cuda(a, b, c, g),
            "gated_rmsnorm_split_bwd": lambda: RN.gated_rmsnorm_split_bwd_cuda(a, b, c, g, ss,
                                                                               dot, width)}


def split_turns(other_rn, gen, card: str) -> None:
    """K2's four split-row entries of both checkouts in bf16 at the training rows of
    SPLIT_WIDTHS split SPLIT_WAYS ways, each through its own checkout's wrapper on
    the same inputs and row sums, timed with the L2 flushed in turns (other, this,
    this, other): the norm bit-equal, the sums within K2's bf16 gate of the
    other's, every backward output within it of the plain version, and the
    elements of dy and dz that differ from the other's counted."""
    from repro_torch.kernels import rmsnorm as RN
    bf16 = torch.bfloat16
    tol = RMS_TOL[bf16]
    for D in SPLIT_WIDTHS:
        for ways in SPLIT_WAYS:
            y, z, sc, dout = gated_bwd_case(gen, (1, 2048, D), bf16)
            a, b, c, g = (split_parts(t, ways)[0] for t in (y, z, sc, dout))
            ss = RN.gated_rmsnorm_stats_cuda(a, b) * ways
            dot = RN.gated_rmsnorm_split_dot_cuda(a, b, c, g)
            tag = f"sass-against split row [2048, {D}] / {ways} bf16"
            mine = split_entries(RN, a, b, c, g, ss, dot, D)
            theirs = split_entries(other_rn, a, b, c, g, ss, dot, D)
            for name in ("gated_rmsnorm_stats", "gated_rmsnorm_split_dot"):
                m, t = mine[name](), theirs[name]()
                check(close(m, t, tol), f"{tag} {name}: max err {max_err(m, t)} from the other's")
            check(torch.equal(mine["gated_rmsnorm_split"](), theirs["gated_rmsnorm_split"]()),
                  f"{tag} gated_rmsnorm_split: the two checkouts' outputs differ")
            got = mine["gated_rmsnorm_split_bwd"](), theirs["gated_rmsnorm_split_bwd"]()
            want = RN.gated_rmsnorm_split_bwd_plain(a, b, c, g, ss, dot, D)
            for who, outs in zip(("this", "other"), got):
                for i, (o, w) in enumerate(zip(outs, want)):
                    check(close(o, w, tol), f"{tag} gated_rmsnorm_split_bwd {who} output {i}: "
                          f"max err {max_err(o, w)}")
            n_diff = sum(int((p != q).sum()) for p, q in zip(got[0][:2], got[1][:2]))
            line = []
            for name in SPLIT_NAMES:
                t = [time_cold_ms(theirs[name]), time_cold_ms(mine[name]),
                     time_cold_ms(mine[name]), time_cold_ms(theirs[name])]
                line.append(f"{name} other {t[0]:.4f}, this {t[1]:.4f}, this {t[2]:.4f}, other "
                            f"{t[3]:.4f} ms ({(t[0] + t[3]) / (t[1] + t[2]):.2f}x)")
            print(f"{tag}, L2 flushed, in turns: {'; '.join(line)}; the norm bit-equal, the "
                  f"sums and the backward within K2's gate, {n_diff} of {2 * a.numel()} "
                  f"elements of dy and dz differ from the other's [{card}]")
            del y, z, sc, dout, a, b, c, g


def phase_sass_against(other: Path, card: str) -> None:
    """Every kernel of the other checkout's csrc/flash_attention.cu,
    csrc/rmsnorm.cu and csrc/ssd_scan.cu (K1's, K2's and K3's, built with this
    checkout's flags) must compile to the same SASS here, but SASS_REPLACED's
    (named, with the reason); the kernels this checkout adds, and any whose SASS
    differs, are named. Then K2's gated entries of the two checkouts run in bf16
    and are timed in turns (other, this, this, other): the forward through this checkout's wrapper, its output
    bit-equal; the backward through each checkout's own entry (other_gated_bwd),
    every output within K2's bf16 gate and the elements of dy and dz that differ
    counted (gated_bwd_held; dscale is summed in another order); then the four
    split-row entries, each checkout's through its own wrappers (split_turns)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as RN
    differ, libs = [], {}
    for name in ("flash_attention", "rmsnorm", "ssd_scan"):
        libs[name], _ = build_other(other, name)
        theirs = sass_functions(_build.BUILD_DIR / f"other-{name}.so")
        mine = sass_functions(_build.library_path(name))
        changed = [n for n in theirs if mine.get(n) != theirs[n]]
        replaced = {reason: [n for n in changed if pattern.search(n)]
                    for pattern, reason in SASS_REPLACED}
        gone = {n for names in replaced.values() for n in names}
        changed = [n for n in changed if n not in gone]
        added = sorted(n for n in mine if n not in theirs)
        print(f"sass-against {name}: {len(theirs) - len(changed) - len(gone)} of "
              f"{len(theirs)} kernels of the other checkout SASS-identical here "
              f"({sum(len(t.splitlines()) for t in theirs.values())} lines); {len(added)} "
              f"added: {', '.join(added)}; {len(changed)} differ: {', '.join(changed)}")
        for reason, names in replaced.items():
            if names:
                print(f"sass-against {name}: {len(names)} replaced, a named exception "
                      f"({reason}): {', '.join(names)}")
        differ += changed
    check(not differ, f"sass-against: SASS differs or is missing for {differ}")

    mine, lib = RN._lib(), libs["rmsnorm"]
    for fn in ("gated_rmsnorm_fwd", "gated_rmsnorm_bwd"):
        getattr(lib, fn).argtypes = getattr(mine, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    blocks = RN._max_blocks(torch.device("cuda"))
    other_bwd = other_gated_bwd(lib.gated_rmsnorm_bwd, fold_scratch(blocks), blocks)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf16 = torch.bfloat16
    fwd_shape, bwd_shape = GATED_TURNS
    y, z = randn(fwd_shape, bf16, gen), randn(fwd_shape, bf16, gen)
    yb, zb, sc, dout = gated_bwd_case(gen, bwd_shape, bf16)

    def fwd():
        return RN.gated_rmsnorm_cuda(y, z, sc)

    bwd = (lambda: other_bwd(yb, zb, sc, dout), lambda: RN.gated_rmsnorm_bwd_cuda(yb, zb, sc, dout))
    ours = fwd()
    with swapped(RN, "_lib", lambda: lib):
        theirs = fwd()
        t = [time_ms(fwd)]
    t += [time_ms(fwd), time_ms(fwd)]
    with swapped(RN, "_lib", lambda: lib):
        t.append(time_ms(fwd))
    check(torch.equal(ours, theirs), f"sass-against gated_rmsnorm {fwd_shape} bf16: the two "
          "checkouts' outputs differ")
    print(f"sass-against gated_rmsnorm {fwd_shape} bf16, outputs bit-equal; in turns: other "
          f"{t[0]:.4f} ms, this {t[1]:.4f} ms, this {t[2]:.4f} ms, other {t[3]:.4f} ms [{card}]")
    n_diff = gated_bwd_held(f"sass-against gated_rmsnorm_bwd {bwd_shape} bf16", bwd[1](),
                            bwd[0](), RN.gated_rmsnorm_bwd_plain(yb, zb, sc, dout), bf16)
    t = [time_ms(bwd[0]), time_ms(bwd[1]), time_ms(bwd[1]), time_ms(bwd[0])]
    print(f"sass-against gated_rmsnorm_bwd {bwd_shape} bf16: every output within K2's gate, "
          f"{n_diff} of {2 * yb.numel()} elements of dy and dz differ from the other's; in "
          f"turns: other {t[0]:.4f} ms, this {t[1]:.4f} ms, this {t[2]:.4f} ms, other "
          f"{t[3]:.4f} ms [{card}]")
    split_turns(other_rmsnorm(other, lib), gen, card)


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
    """K2's four backward entry points of this checkout against those of another
    checkout, in one process on this card, through the same C entry points (the
    other called as its own wrapper calls it: one launch, dscale folded through a
    zeroed f64 scratch of tickets and rows, one of its own a width, which each
    launch leaves with its tickets at 0). Over the check sweeps,
    f32 dx (dq, dk) must be bit-equal between the two, and every output of both
    must hold the plain version's gate (f32 against the plain version in f64);
    the gated entry's f32 outputs held against gated_bwd_exact, and its dy and dz
    bit-equal to the other's where each row's sums keep their order (gated_bwd_held;
    the differing elements counted elsewhere). Then each bf16 entry is timed at the
    training shapes in turns (other, this, this, other) and profiled once a
    design, kernel by kernel."""
    from repro_torch.kernels import rmsnorm as RN
    f32, bf16 = torch.float32, torch.bfloat16
    lib, kernels = build_other(parent, "rmsnorm")
    print("k2-bwd-against: the other checkout's K2 backward kernels, registers: "
          + ", ".join(gated_registers(kernels, strict=False)))
    fns = {}
    for name in K2_BWD_ENTRIES + ("gated_rmsnorm_bwd",):
        fns[name] = getattr(lib, name)
        fns[name].argtypes, fns[name].restype = getattr(RN._lib(), name).argtypes, ctypes.c_int
    blocks = RN._max_blocks(torch.device("cuda"))
    scratch = fold_scratch(blocks)

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
        "gated_rmsnorm_bwd": (RN.gated_rmsnorm_bwd_cuda,
                              other_gated_bwd(fns["gated_rmsnorm_bwd"], scratch, blocks),
                              RN.gated_rmsnorm_bwd_plain, gated_bwd_case, GATED_BWD_SWEEP, 2),
    }
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    timed = {"rmsnorm_bwd": [(4, 2048, 1024)], "add_rmsnorm_bwd": [(4, 2048, 1024)],
             "qk_norm_rope_bwd": [(4, 2048, 16, 8, 128)], "gated_rmsnorm_bwd": GATED_BWD_TIMED}
    for name, (this, other, plain, make, sweep, n_dx) in entries.items():
        differ = {}      # the gated entry's (shape, dtype) -> elements of dy, dz that differ
        for shape in sweep:
            for dtype in (f32, bf16):
                tag = f"k2-bwd-against {name} {shape} {dtype}"
                args = make(gen, *shape, dtype) if name == "qk_norm_rope_bwd" else \
                    make(gen, shape, dtype)
                mine, theirs = this(*args), other(*args)
                if name == "gated_rmsnorm_bwd":
                    want = gated_bwd_exact(*args) if dtype == f32 else plain(*args)
                    n = gated_bwd_held(tag, mine, theirs, want, dtype)
                    if n:
                        differ[shape, str(dtype).split(".")[-1]] = n
                    continue
                want = plain(*(exact(args) if dtype == f32 else args))
                if dtype == f32:
                    check(all(torch.equal(a, b) for a, b in zip(mine[:n_dx], theirs[:n_dx])),
                          f"{tag}: f32 dx differs between the checkouts")
                for who, got in (("this", mine), ("other", theirs)):
                    for i, (g, w) in enumerate(zip(got, want)):
                        check(close(g, w, RMS_TOL[dtype]), f"{tag} {who} output {i}: max err "
                              f"{max_err(g, w)}")
        held = (f"dy and dz bit-equal across the two checkouts where each row's sums keep "
                f"their order; elements that differ (rows past 128 vectors): {differ}"
                if name == "gated_rmsnorm_bwd" else "f32 dx bit-equal across the two checkouts")
        print(f"k2-bwd-against {name}: {len(sweep)} shapes: {held}; every output of both "
              "within the plain version's gate")
        for shape in timed[name]:
            args = make(gen, *shape, bf16) if name == "qk_norm_rope_bwd" else \
                make(gen, shape, bf16)
            t = [time_ms(lambda: other(*args)), time_ms(lambda: this(*args)),
                 time_ms(lambda: this(*args)), time_ms(lambda: other(*args))]
            print(f"k2-bwd-against {name} {shape} bf16, in turns: other {t[0]:.4f} ms, this "
                  f"{t[1]:.4f} ms, this {t[2]:.4f} ms, other {t[3]:.4f} ms [{card}]")
            profile_breakdown(f"k2-bwd-against {name} {shape} bf16, other",
                              lambda: other(*args), top=3)
            profile_breakdown(f"k2-bwd-against {name} {shape} bf16, this",
                              lambda: this(*args), top=3)
            del args


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
    rec["titchener_pods"] = dryrun_titchener_pods()
    rec["production"] = dryrun_production()
    Path(out).write_text(json.dumps(rec))


def dryrun_titchener_pods() -> dict:
    """The dry-run of qwen3-0.6b's Titchener round at full width and depth on a fake
    (2, 1, 1) ("pod", "data", "model") world, as rank 0: H = 1 and the batch cut to
    CELLS_TRAIN_BATCH rows (the exchange's bytes depend on neither); its
    collectives, a pod of one rank."""
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    from repro_torch.launch.steps import CellOptions, build_cell
    from repro_torch.models.params import TensorDef
    from repro_torch.roofline.op_stats import call_stats, stats_to_json
    import torch.distributed as dist
    t0 = time.perf_counter()
    with fake_world(2):
        mesh = make_test_mesh((2, 1, 1), POD_AXES, device="cpu")
        cell = build_cell(CELLS_ARCH, "train_4k",
                          CellOptions(titchener=True, extra=(("inner_steps", 1),)),
                          device="cpu", mesh=mesh)
        state, batch = cell.abstract_args
        lead = (1, 2, CELLS_TRAIN_BATCH // 2)
        cut = {k: TensorDef(lead + d.shape[3:], d.dtype) for k, d in batch.items()}
        rec = stats_to_json(call_stats(cell.fn, (state, cut), mesh, cell.in_shardings,
                                       pod_size=1))
    check(not dist.is_initialized(), "the fake world outlived its block")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def dryrun_production() -> dict:
    """``launch/dryrun.py``'s record of DRYRUN_PRODUCTION on its production mesh
    of fake ranks, with the report's row of it."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.steps import CellOptions
    from repro_torch.roofline.report import row_from_artifact
    arch, shape, mesh = DRYRUN_PRODUCTION
    t0 = time.perf_counter()
    rec = run_cell(arch, shape, CellOptions(), verbose=False, mesh=mesh)
    check(not dist.is_initialized(), "the fake world outlived its block")
    row = row_from_artifact(rec)
    rec["row"] = {"compute_s": row.compute_s, "memory_s": row.memory_s,
                  "collective_s": row.collective_s, "dominant": row.dominant,
                  "fits": row.fits, "mem_gb": row.mem_gb}
    rec["seconds"] = time.perf_counter() - t0
    return rec


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
    ms as a share of PEAK_FLOPS_BF16. Then the same process's fake-group dry-runs:
    the Titchener round's cross-pod bytes on (2, 1, 1) exactly those a rank sent
    over "pod" a round in ``phase_local_sgd_pods``, all of them all-gathers; and
    DRYRUN_PRODUCTION's per-device peak, terms and fit on 512 fake ranks."""
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
    tp = rec["titchener_pods"]
    sent = MEASURED["pod_bytes_a_round"]
    print(f"dry-run of qwen3-0.6b's Titchener round on a fake (2, 1, 1) world (full width and "
          f"depth, H = 1, {tp['seconds']:.1f} s): cross-pod {tp['cross_pod_bytes']:,} bytes a "
          f"device ({tp['by_opcode']}); a rank of phase 10's two sent {sent:,.0f} over 'pod' "
          f"a round")
    check(tp["cross_pod_bytes"] == sent and set(tp["by_opcode"]) == {"all-gather:dcn"},
          f"dry-run of the Titchener round: {tp['cross_pod_bytes']} cross-pod bytes "
          f"({tp['by_opcode']}), a rank sent {sent} over 'pod'")
    prod = rec["production"]
    row, hs = prod["row"], prod["hlo_stats"]
    print(f"dry-run of {prod['cell']} on the {prod['mesh']} mesh ({prod['chips']} fake ranks, "
          f"torch {torch.__version__}, {prod['seconds']:.1f} s): per device peak "
          f"{hs['peak_bytes'] / 1e9:.2f} GB, flops {hs['flops']:.4e}, in-pod "
          f"{hs['in_pod_bytes']:.4e} and cross-pod {hs['cross_pod_bytes']:.4e} bytes; compute "
          f"{row['compute_s']:.4f} s, memory {row['memory_s']:.4f} s, collective "
          f"{row['collective_s']:.4f} s, {row['dominant']}-bound, fits {row['fits']}")
    check(prod["chips"] == 512 and hs["flops"] > 0 and hs["in_pod_bytes"] > 0,
          f"dry-run of {prod['cell']}: {prod['chips']} chips, flops {hs['flops']}")


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
                    help="only build the kernels and check that every K1, K2 and K3 kernel "
                         "of another checkout compiles to the same SASS here")
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
            *phase_ssm_backward(gen), *phase_split_norm(gen)]
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
    by_path[ELASTIC_PATH] = phase_elastic(card)
    mark("elastic done")
    by_path[TP_PATH] = phase_tensor_parallel(card)
    mark("tensor-parallel done")
    by_path.update(phase_ssm_tensor_parallel(card))
    mark("ssm and hybrid tensor-parallel done")
    by_path.update(phase_xattn_tensor_parallel(card))
    mark("encdec and vlm tensor-parallel done")
    by_path.update(phase_moe_tensor_parallel(card))
    mark("moe expert-parallel done")
    by_path.update(phase_local_sgd_pods(card))
    mark("local SGD pods done")
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
        row["launches_by_path"] = {path: n.get(row["name"], 0) for path, n in by_path.items()
                                   if n.get(row["name"], 0)}
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
