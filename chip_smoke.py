#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel of the path (``nvcc`` for sm_90a, from
   ``src/repro_torch/kernels/csrc``);
2. each kernel against its plain PyTorch version on the card, exactly, then
   both timed with CUDA events at the main path's shape beside the bound;
3. characterization: the sor crash campaign reproduces its pinned golden
   (``tests/golden/campaign_goldens.json``) on the card, and ``run_workflow``
   gives the plan the JAX package gives;
4. deployment: SOR at grid 8192 (u, res and b are 256 MiB each in float32)
   runs under ``EasyCrashManager`` with that plan and delta flushes whose
   masks come from the ``delta_snapshot`` kernel; then a crash, a restore
   from the NVM arena, and more iterations from the restored state, each
   flushed again through the kernel against the shadow the restore left;
5. flash attention: the ``flash_attention`` kernels (the bf16 ``wgmma``
   route, the f32 SIMT route) against their plain version on the card over
   a grid of dtypes, head dims, masks, lengths and tiles, the bf16 route's
   edges (windows under its kv tile, non-causal windows, ragged S) and the
   serving paths' prefill shapes (StableLM-2-1.6B's; RecurrentGemma-9B's
   D 256 with k and v repeated from one kv head, window 2048;
   Qwen1.5-MoE-A2.7B's 16 heads of D 128; Llama-4-Scout's 40 q heads over 8
   kv heads of D 128); rows wholly masked inside live tiles against a
   float64 softmax over their keys; two bf16 launches bit for bit; then
   kernel, plain version and ``F.scaled_dot_product_attention`` (the
   library yardstick, never on the path) timed at each shape beside its
   bound, and the op as the path calls it (with ``_repeat_kv``);
6. decode characterization: the decode crash campaign reproduces its pinned
   golden on the card, and ``run_workflow`` gives the JAX package's plan;
7. serving at full width: StableLM-2-1.6B (24 layers, 1.64 B parameters,
   random bf16 weights from a seeded generator) prefills 4 prompts of 1024
   tokens with the flash-attention kernel (checked against the reference
   prefill in float32 weights, then timed alone and warm three times),
   decodes 64 tokens and delta-flushes the KV cache every 16
   steps through ``delta_snapshot``; then a crash at step 32 and a resume
   from the reattached arena, whose token stream must equal the
   uninterrupted one;
8. the recurrent kernels: ``rwkv6_scan`` (output and final state) and
   ``rglru_scan`` (bit for bit, also on its direct path for rows off 16
   bytes) against their plain versions on the card over dtypes, blocks,
   head dims and ragged lengths, each kernel's ptxas registers and spills
   (none allowed), then both timed at the serving paths' shapes beside
   their bounds;
9. serving RWKV6-3B at full width and depth (32 layers, random bf16
   weights): its kernel prefill against the reference prefill in float32
   weights, then the same flow as phase 7 (4 prompts of 1024 tokens, 64
   steps, a delta flush every 16, a crash at 32, a resume), with every
   flushed image equal to the live bytes and the resumed stream equal to
   the uninterrupted one; the prefill runs ``rwkv6_scan`` once per layer,
   and the decode cache's state comes from the scan;
10. serving RecurrentGemma-9B at full width and depth (38 layers, 26 RG-LRU
   and 12 local-attention layers) the same way, its float32 comparison at
   a reduced depth of 5 layers; the prefill runs ``rglru_scan`` once per
   RG-LRU layer (the cache's state is the scan's last step) and
   ``flash_attention`` once per attention layer.  Both prefills are
   profiled once: wall time, and the scan kernels' device time within it;
11. the HPC suite's heat, cg, pagerank and kmeans and the lm-train app
   characterized on the card: each HPC app's crash campaign reproduces its
   pinned golden and ``run_workflow`` gives the JAX package's plan; lm-train
   (the port's own generator weights) gives the same campaign and plan on
   the card as on the CPU; for each app, the first iteration at which the
   card's golden run leaves the CPU's bits (information);
12. each of the five deployed at one GPU's size as phase 4 deploys SOR (16
   iterations under ``EasyCrashManager``, every flush through
   ``delta_snapshot`` with its image equal to the live bytes, a crash, a
   restore equal to the last flushed bytes, 4 more iterations): cg and heat
   at grid 8192, pagerank at 32,768 nodes (4 GiB of links), kmeans at
   4,194,304 points, lm-train at width 2048 (about 110 M parameters).  cg,
   pagerank and kmeans flush their plan's objects; heat and lm-train, whose
   plans flush nothing, flush the selected object at the end of every
   iteration: the paper's loop-end baseline (Fig 2a);
13. mg and montecarlo characterized on the card: each campaign reproduces
   its pin (mg its torn-write pin too), ``run_workflow`` gives the JAX
   package's plan, and the card's golden run is held against the CPU's
   (information); then, for each of the six apps with a lane driver (cg,
   heat, kmeans, pagerank, mg, montecarlo), ``advance_lanes`` on the card (a
   CUDA graph of a chunk of masked steps; montecarlo's bespoke replay)
   equals the serial loop on the card bit for bit for lanes entering at
   scattered iterations, and phase A of the pinned campaign is timed with
   the driver and with the host loop (ms and host syncs; information);
14. mg at grid 8192 and montecarlo at 2**26 pairs per iteration deployed as
   phase 12 deploys, each flushing its plan's objects after the two
   regions its plan names (so twice per iteration);
15. the trainer under failures (``repro_torch.launch.train``) at
   StableLM-2-1.6B's full width, its depth cut to 4 of 24 layers (616 M
   parameters; bf16 weights, f32 moments, grad_accum 2; batch 8 of 64
   tokens): (a) 24 steps with no flush and no checkpoint; (b) 24 steps
   with asynchronous delta flushes of the parameters and step every 4
   (every arena image checked against its flush's clone), checkpoints
   every 8 (the stretched Young interval of --mtbf 6 --t-chk 1
   --recomputability 0.82) and a crash at 12, restored from the arena at
   12 with the parameters equal to its image; (c) the arena deleted, a
   restart to 28 restored from the local checkpoint of step 24; (d) the
   local tier deleted too, from the remote tier; (e) with the arena back
   and --verify-loss-max 0, from the checkpoint; each restored state
   equal to the bytes on disk; ``delta_snapshot`` once per tensor leaf
   and delta flush; the persistence tax, the flush split, the checkpoint
   writes and the measured T_chk with efficiency_with/without;
16. ``serve.fleet_report`` on phase 7's uninterrupted run at the
   launcher's fleet defaults (4 replicas, MTBF 900 s, horizon 1800 s):
   every policy's line, and request conservation for each;
17. the MoE archs: (a) Qwen1.5-MoE-A2.7B at full width and depth (24
   layers, 60 routed experts top-4, a shared MLP; 14,315,587,584 parameters
   asserted, bf16 with an f32 router) served as phase 7 serves StableLM
   (4 prompts of 1024 tokens, 64 steps, a delta flush every 16, a crash at
   32, a resume equal to the uninterrupted stream, every flushed image equal
   to the live bytes); its kernel prefill against the reference prefill at
   2 layers in float32 weights, with the routers' top-k sets that differ
   counted; ``flash_attention`` once per layer and prefill at D 128; the
   slots dropped at capacity counted per prefill; one warm prefill profiled
   into attention, router, dispatch, expert products, combine and shared
   MLP, and 8 decode steps with the device's idle share; (b)
   Llama-4-Scout-17B-16E at full width with its depth cut to 2 of 48 layers
   (top-1 of 16 experts, a shared expert; 40 q heads over 8 kv heads): its
   kernel prefill against the reference prefill in float32 weights, 8
   greedy steps from each prefill's cache giving the same tokens, and its
   bf16 kernel prefill timed; (c) ``flash_attention`` at Qwen's shape,
   timed in phase 5.

18. static analysis (slice 10): ``analyze_app`` on the card for the seven
   HPC apps at CI size, each held against the same analysis on the CPU in
   this process (traced flags, classes, decisions, write_bytes, uncertain
   regions equal; confidence and damping within 1e-4) and against
   ``tests/golden/static_agreement.json``'s agreement pattern (sor,
   pagerank, kmeans, heat and montecarlo agree; mg and cg miss exactly as
   annotated); ``run_workflow`` on sor on the card with ``static`` (0
   tests), ``static+verify`` (80) and ``adaptive`` (the default sampler and
   the exact one, the counts of ``tests/golden/adaptive_goldens.json``),
   each giving the JAX plan; the determinism lint over every app's batched
   kernels built on the card (no finding); then sor's static plan, derived
   at grid 8192 with no campaign, deployed as phase 4 deploys the measured
   one, every delta flush through ``delta_snapshot``.

19. the port's examples and deployment tooling (slice 11): (a) the six
   ``examples/torch_*.py`` each in a subprocess on the card and, at the same
   time, on the CPU (quickstart; crash_campaign --tests 8 --iters 10;
   workflow_orchestrate --tests 8; system_efficiency --tests 8 --failures
   200; serve_recovery --tests 4; train_lm --steps 62 --tests 4): each exits
   0 without loading jax, each plan equals the CPU run's, the serving
   example's resumed stream (its arena's tokens) equals an uninterrupted
   serve of the same flags on the card, and the examples' ``flash_attention``
   and ``delta_snapshot`` launches are counted; (b) the dry-run's "h100"
   cell (``launch/dryrun.py`` on a 1 x 1 mesh of the card) at phase 15's
   trainer (StableLM-2-1.6B's width, 4 layers, batch 8 of 64, grad_accum 2):
   its roofline terms, then one step of the trainer profiled, which fails
   the run if its device time is below max(compute_s, memory_s); predicted
   against measured time and peak memory; (c) run inside phase 15 before
   its work directory is deleted: ``reshard_restore`` of its newest
   checkpoint onto the "h100" mesh, every leaf equal to the checkpoint's
   bytes, and one train step from it equal, bit for bit, to one step from
   ``launch/train.py``'s own restore of that checkpoint.

20. the dry-run's kernel cells (slice 12): ``dryrun.cell(...,
   impl="kernel")`` on the "h100" mesh at the served cells' prefill shape (4
   prompts of 1024 tokens) for RWKV6-3B cut to 4 layers, RecurrentGemma-9B
   cut to one (rec, rec, attn) repetition and Qwen1.5-MoE-A2.7B cut to 2
   layers, all at full width: each cell launches ``rwkv6_scan``,
   ``rglru_scan`` and ``flash_attention`` (as ``torch.library`` custom ops
   on DTensors) exactly once per layer of their kind; its roofline bound
   must not exceed the device time of a profiled prefill of the same
   configuration on plain tensors; and each op called on 1 x 1 DTensors
   gives the direct call's bits.
21. the padded head layout (slice 13): the production meshes' 16-way
   "model" axis does not divide 40 heads, so the dry-run places parameters
   padded to 48 (``models/padding.py``); the same ``pad_params`` on plain
   tensors of the card, at full width: Llama-4-Scout cut to 2 layers
   (phase 17 (b)'s model and seed; 40 -> 48 q heads, 8 groups of 5 -> 6,
   through ``flash_attention``) and RWKV6-3B cut to 4 layers (40 -> 48
   heads through ``rwkv6_scan``).  Each prefills 4 prompts of 1024 tokens
   padded and unpadded: in float32 weights the padded logits are within
   1e-5 (of the largest logit) of the unpadded ones; in bf16 each prefill
   decodes 8 greedy steps and the tokens are equal; every padded head's
   output before the output projection (and RWKV's padded state after the
   steps) is exactly 0; the kernels' launches are counted and asserted.
22. Granite-4.0-H-Micro: (a) ``ssm_update`` against its plain version at
   the decode cell's shape (32 sessions x 64 heads of 64 x 128 float32
   states) and four ragged ones (state within 1e-5, output within 1e-4),
   then timed at that shape beside its byte bound and the plain version;
   (b) the server at full width, as phase 6 runs StableLM's (4 prompts of
   1024 tokens, 64 greedy steps flushed every 16, a failure injected at 32
   and resumed; every flush's images against the live bytes: the Mamba-2
   states go whole into the arena's image, the K/V cache's dirty blocks
   gathered on the card), with the launches of ``ssm_update``,
   ``flash_attention`` and ``delta_snapshot`` zeroed before it and held to
   one a Mamba-2 layer and step, one an attention layer and prefill, one a
   tensor leaf and delta flush.

``python3 chip_smoke.py --only granite`` runs phases 1 and 22 alone.

Every campaign's phase A goes through the apps' lane drivers; a driver that
raises and falls back to the host loop fails the run.

The second line from the end is a JSON object with one entry per kernel,
the last is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script prints no result and exits with 2; outside the repository it cannot
import the port and exits with 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import host_array, state_to_torch  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.analysis import analyze_app, lint_app  # noqa: E402
from repro_torch.core import (  # noqa: E402
    POLICIES,
    CrashTester,
    EasyCrashManager,
    FlushPolicy,
    NVMArena,
    PersistPlan,
    SequentialConfig,
    WorkflowConfig,
    run_workflow,
)
from repro_torch.core import lane_driver  # noqa: E402
from repro_torch.core.faults import get_fault_model  # noqa: E402
from repro_torch.core.manager import flatten_state  # noqa: E402
from repro_torch.hpc.common import laplacian_apply  # noqa: E402
from repro_torch.hpc.sor import SORApp, _rb_sor  # noqa: E402
from repro_torch.hpc.suite import app_names, ci_app, default_cache, get_app  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.delta_snapshot import dirty_block_mask  # noqa: E402
from repro_torch.kernels.delta_snapshot.ref import dirty_block_mask_reference  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_reference  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_reference  # noqa: E402
from repro_torch.kernels.ssm_update import ssm_update  # noqa: E402
from repro_torch.kernels.ssm_update.ref import ssm_update_reference  # noqa: E402
from repro_torch.checkpoint import load_pytree, system_config_from_measurement  # noqa: E402
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager, reshard_restore  # noqa: E402
from repro_torch.checkpoint.serialization import flatten_tree  # noqa: E402
from repro_torch.core.efficiency import efficiency_with, efficiency_without  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import mesh_for_name, release  # noqa: E402
from repro_torch.launch.steps import make_decode_fn, train_state_specs  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models import init_cache, init_params, moe, prefill  # noqa: E402
from repro_torch.models.attention import _repeat_kv  # noqa: E402
from repro_torch.models import attention, rwkv6  # noqa: E402
from repro_torch.models.padding import (  # noqa: E402
    attn_heads, pad_cache, pad_params, q_groups, rwkv_heads)

#: H100 SXM device-memory rate, bytes/s, and dense bf16 tensor-core rate,
#: FLOP/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989.4e12
#: H100 SXM float32 rate outside the tensor cores, FLOP/s (an FMA is 2)
F32_FLOPS_PER_S = 67e12
#: the deployment's grid: u is 8192^2 float32 = 256 MiB
DEPLOY_GRID = 8192
DEPLOY_ITERS = 16
AFTER_RESTORE_ITERS = 4
BLOCK_BYTES = 64
GOLDENS = os.path.join(ROOT, "tests", "golden", "campaign_goldens.json")
#: the plan the JAX package's run_workflow gives for ci_app("sor"),
#: WorkflowConfig(n_tests=24, cache=default_cache(app), seed=0)
JAX_SOR_PLAN = (("u",), {1: 4, 2: 1})
#: the same for ci_app("decode")
JAX_DECODE_PLAN = (("tokens",), {1: 1})
#: the same for the HPC apps of the slice after sor
JAX_HPC_PLANS = {
    "heat": (("u",), {}),
    "cg": (("q",), {2: 1, 3: 1}),
    "pagerank": (("rank",), {0: 1, 1: 1, 2: 1}),
    "kmeans": (("centroids",), {0: 1, 1: 1}),
}
#: the deployments at one GPU's size, in the order they run: cg and heat at
#: SOR's grid (each vector 256 MiB); pagerank's dense links at 4 GiB of f32;
#: kmeans' points 128 MiB (its (n, k) distance terms 192 MiB each); lm-train
#: at StableLM-2-1.6B's d_model (about 110 M parameters, 440 MB per vector),
#: with lr 6e-4, GPT-3's for its 125M model (Brown et al. 2020, Table 2.1):
#: the app's default 2e-2, tuned at width 64, diverges at this width (the
#: eval loss climbs from 6.06 to over 20 in five steps and the gradients
#: turn NaN within eight, on the CPU as on the card)
DEPLOY_APPS = (
    ("cg", dict(grid=DEPLOY_GRID)),
    ("pagerank", dict(n_nodes=32768)),
    ("kmeans", dict(n_points=4194304)),
    ("heat", dict(grid=DEPLOY_GRID)),
    ("lm-train", dict(width=2048, lr=6e-4)),
)
#: the same for mg and montecarlo (slice 7)
JAX_SLICE7_PLANS = {
    "mg": (("u",), {1: 1, 3: 1}),
    "montecarlo": (("counts", "sums"), {0: 1, 1: 1}),
}
#: every app with a lane driver, and the field each lane is perturbed in
DRIVER_NOISE_FIELD = {"cg": "x", "heat": "u", "kmeans": "centroids", "pagerank": "rank",
                      "mg": "u", "montecarlo": "sums"}
#: slice 7's deployments: mg at SOR's grid (u, r and b 256 MiB each, ec 64
#: MiB); montecarlo at 2**26 pairs per iteration (scratch 256 MiB), whose
#: 20 iterations draw 1.34e9 pairs, about NPB EP class B's 2**30
DEPLOY_SLICE7 = (
    ("mg", dict(grid=DEPLOY_GRID)),
    ("montecarlo", dict(batch=1 << 26)),
)
#: static analysis (phase 18): the suite, its goldens, and the pins of
#: tests/test_static_plan.py: the apps whose static persist regions equal
#: the measured ones, and per miss (static-only, measured-only) regions
STATIC_SUITE = ("sor", "pagerank", "kmeans", "heat", "mg", "cg", "montecarlo")
STATIC_AGREEMENT = os.path.join(ROOT, "tests", "golden", "static_agreement.json")
ADAPTIVE_GOLDENS = os.path.join(ROOT, "tests", "golden", "adaptive_goldens.json")
STATIC_AGREE = {"sor", "pagerank", "kmeans", "heat", "montecarlo"}
STATIC_MISSES = {"mg": ([2], [1]), "cg": ([1], [])}
#: sor's static+verify workflow at n_tests 40: baseline and best campaigns only
STATIC_VERIFY_TESTS = 80
#: the serving path: StableLM-2-1.6B unscaled, 4 prompts of 1024 tokens
SERVE_ARCH = "stablelm-1.6b"
SERVE_PROMPTS, SERVE_PROMPT_LEN, SERVE_STEPS, SERVE_FLUSH_EVERY = 4, 1024, 64, 16
SERVE_CRASH_AT = 32
SERVE_WORKDIR = os.path.join(ROOT, "build", "chip_smoke_serve")
#: the prefills' attention shapes (B, S, H, D) at full width, with their kv
#: heads (repeated to H before the kernel) and window: StableLM-2-1.6B's,
#: and RecurrentGemma-9B's local attention (16 q heads over 1 kv head)
ATTN_SHAPE = (SERVE_PROMPTS, SERVE_PROMPT_LEN, 32, 64)
RG_ATTN_SHAPE = (SERVE_PROMPTS, SERVE_PROMPT_LEN, 16, 256)
#: Qwen1.5-MoE-A2.7B's (16 heads of D 128), and Llama-4-Scout's (40 q heads
#: over 8 kv heads of D 128)
QWEN_ATTN_SHAPE = (SERVE_PROMPTS, SERVE_PROMPT_LEN, 16, 128)
SCOUT_ATTN_SHAPE = (SERVE_PROMPTS, SERVE_PROMPT_LEN, 40, 128)
ATTN_PATHS = {"serve_stablelm": (ATTN_SHAPE, 32, None),
              "serve_recurrentgemma": (RG_ATTN_SHAPE, 1, 2048),
              "serve_qwen2_moe": (QWEN_ATTN_SHAPE, 16, None),
              "llama4_scout_prefill": (SCOUT_ATTN_SHAPE, 8, None)}
#: the recurrent serving paths, same prompts, steps and flushes
RWKV_ARCH, RG_ARCH = "rwkv6-3b", "recurrentgemma-9b"
#: rwkv6_scan's shape on RWKV6-3B's prefill (B, S, H, D); rglru_scan's on
#: RecurrentGemma-9B's (B, T, d_rnn)
RWKV_SHAPE = (SERVE_PROMPTS, SERVE_PROMPT_LEN, 40, 64)
RGLRU_SHAPE = (SERVE_PROMPTS, SERVE_PROMPT_LEN, 4096)
#: the trainer (slice 8): StableLM-2-1.6B at full width with its depth cut
#: from 24 layers to 4 (616,581,120 parameters; a checkpoint of bf16
#: parameters and f32 moments is about 6.17 GB), at the launcher's batch 8
#: of 64 tokens; 24 steps, a delta flush every 4, a crash at 12, then
#: restarts to 28 steps.  --mtbf 6 --t-chk 1 --recomputability 0.82 put the
#: stretched Young interval at sqrt(2 * 1 * 6 / 0.18) = 8.16 -> 8 steps.
TRAIN_ARCH, TRAIN_LAYERS = "stablelm-1.6b", 4
TRAIN_STEPS, TRAIN_MORE_STEPS, TRAIN_FLUSH_EVERY, TRAIN_CRASH_AT = 24, 28, 4, 12
TRAIN_CKPT_FLAGS = ("--mtbf", "6", "--t-chk", "1", "--recomputability", "0.82")
TRAIN_CKPT_EVERY = 8
#: the launcher's defaults, at which efficiency_with/without are evaluated
TRAIN_EFF_MTBF, TRAIN_EFF_R = 300.0, 0.82
TRAIN_WORKDIR = os.path.join(ROOT, "build", "chip_smoke_train")
#: the MoE serving path (slice 9): Qwen1.5-MoE-A2.7B unscaled (24 layers,
#: 60 routed experts top-4 of width 1408, a shared MLP of 5632; bf16
#: weights, f32 router), its prefills compared at a depth cut of 2 layers;
#: Llama-4-Scout-17B-16E at full width (16 experts top-1 of 8192, a shared
#: expert of 8192, 40 q heads over 8 kv heads), its depth cut from 48
#: layers to 2 (about 6.5 B parameters): the whole model is about 108 B
#: parameters, 216 GB in bf16, over one card's 80 GB
MOE_ARCH, MOE_PARAMS, MOE_COMPARE_LAYERS = "qwen2-moe-a2.7b", 14_315_587_584, 2
SCOUT_ARCH, SCOUT_LAYERS, SCOUT_DECODE_STEPS = "llama4-scout-17b-a16e", 2, 8
#: the port's examples (phase 19) at the CPU tests' sizes; train_lm runs past
#: its injected failure at step 60 so that it restores from the arena
EXAMPLES = (
    ("quickstart", ()),
    ("crash_campaign", ("--tests", "8", "--iters", "10")),
    ("workflow_orchestrate", ("--tests", "8")),
    ("system_efficiency", ("--tests", "8", "--failures", "200")),
    ("serve_recovery", ("--tests", "4")),
    ("train_lm", ("--steps", "62", "--tests", "4")),
)
#: the lines of each example's report that state its plan (or, for
#: system_efficiency, the profile it measured)
EXAMPLE_PLAN_LINES = {
    "quickstart": r"^knapsack plan .*$",
    "crash_campaign": r"^persist \(.*\) at loop end",
    "workflow_orchestrate": r"^(?:critical objects|plan): .*$",
    "system_efficiency": r"^(?:measuring|rates): .*$",
    "serve_recovery": r"^(?:critical decode state|plan): .*$",
    "train_lm": r"^plan: .*$|^\[restore\] source=easycrash step=60$",
}
#: the serving example's server flags (examples/torch_serve_recovery.py)
EXAMPLE_SERVE_FLAGS = ("--arch", "stablelm-1.6b", "--width", "128", "--prompts", "4",
                       "--prompt-len", "32", "--decode-steps", "48", "--flush-every", "4",
                       "--persist-mode", "delta")
#: the dry-run's cell at phase 15's trainer: batch 8 of 64 tokens
DRYRUN_SHAPE = ShapeConfig("train_phase15", 64, 8, "train")
#: the dry-run's kernel cells (phase 20), at the served cells' prefill shape
#: (4 prompts of 1024 tokens): each arch at full width, its first layer
#: group cut to this many repetitions
DRYRUN_PREFILL = ShapeConfig("prefill_4x1024", SERVE_PROMPT_LEN, SERVE_PROMPTS, "prefill")
DRYRUN_KERNEL_CELLS = (("dryrun-h100-rwkv6x4", RWKV_ARCH, 4),
                       ("dryrun-h100-rgx3", RG_ARCH, 1),
                       ("dryrun-h100-qwen2-moex2", MOE_ARCH, 2))
#: the layer kind each model kernel runs once per layer of
KERNEL_KIND = {"rwkv6_scan": "rwkv", "rglru_scan": "rec", "flash_attention": "attn"}
#: the padded head layout (phase 21): the production meshes' "model" axis,
#: the models (arch, layers, the kernel their heads go through) and the
#: greedy steps after each prefill; float32 logits held to this share of
#: the largest logit
PAD_SPLIT = 16
PAD_MODELS = (("scout", SCOUT_ARCH, SCOUT_LAYERS, "flash_attention"),
              ("rwkv6", RWKV_ARCH, 4, "rwkv6_scan"))
PAD_DECODE_STEPS, PAD_F32_TOL = 8, 1e-5
# phase 22: Granite-4.0-H-Micro; ssm_update's shapes as (sessions, heads, P,
# N, groups), the decode cell's first
GRANITE_ARCH = "granite-4.0-h-micro"
SSM_CASES = ((32, 64, 64, 128, 1), (3, 6, 10, 20, 2), (2, 4, 33, 256, 4), (1, 2, 8, 512, 1),
             (5, 3, 64, 4, 3))
SSM_STATE_TOL, SSM_OUT_TOL = 1e-5, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def delta_bound_ms(nbytes: int, block_bytes: int) -> float:
    """Least time for the mask: both inputs read once, the int32 mask
    written once, at the device-memory rate."""
    n_blocks = -(-nbytes // block_bytes)
    return (2 * nbytes + 4 * n_blocks) / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------- 1. environment
def phase_environment() -> str:
    gpu = gpu_name_and_power()
    log(f"[env] gpu: {gpu}")
    log(f"[env] torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = _build.build("delta_snapshot", "flash_attention", "rwkv6_scan", "rglru_scan",
                         "ssm_update")
    log(f"[env] built {', '.join(os.path.relpath(str(p), ROOT) for p in paths.values())} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if name != "flash_attention" and ("registers" in line or "spill" in line):
                log(f"[env] ptxas {name}: {line.strip()}")
    for kernel, info in flash_ptxas().items():
        log(f"[env] ptxas flash_attention {kernel}: {info}")
    return gpu


def flash_ptxas() -> dict:
    """Registers, stack and spills of each flash-attention kernel from the
    ptxas report of its build (``-Xptxas -v``, kept beside the library),
    with any wgmma serialization warning; {} if no report was kept."""
    text = _build.BUILD_LOGS.get("flash_attention", "")
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\S*flash_(wgmma|simt)_kernelILi(\d+)E(?:Li(\d+)E)?",
                      line)
        if m:
            route, d, kv = m.groups()
            name = f"{route} D={d}" + (f" kv={kv}" if kv else "")
            out[name] = {}
        elif name and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[name].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    warnings = [line.strip() for line in text.splitlines() if "wgmma" in line and "C75" in line]
    if warnings:
        out["warnings"] = warnings
    return out


# --------------------------------------------- 2. kernel against plain version
def _kernel_cases(dev: str):
    """(label, x, prev, block_elems): sparse random dirt, an all-clean pair,
    planted float specials, and an unaligned view (the scalar kernel)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in (0, 1, 63, 64, 65, 4097, (256 << 20) + 3):
        x = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)
        p = x.clone()
        if n:
            idx = torch.randint(0, n, (max(1, n // 1000),), generator=gen, device=dev)
            p[idx] += 1
        yield f"uint8 n={n} sparse", x, p, 64
        yield f"uint8 n={n} clean", x, x.clone(), 64
    base = torch.randint(0, 256, (4098,), generator=gen, device=dev, dtype=torch.uint8)
    other = base.clone()
    other[[7, 2000, 4097]] += 1
    yield "uint8 n=4097 unaligned view", base[1:], other[1:], 64
    for n in (1, 255, 256, 257, 4097, 1 << 20):
        x = torch.randn(n, generator=gen, device=dev)
        p = x.clone()
        idx = torch.randint(0, n, (max(1, n // 1000),), generator=gen, device=dev)
        p[idx] += 1.0
        if n >= 1024:
            x[3] = float("nan")                        # NaN vs a number: dirty
            x[300] = p[300] = float("nan")             # NaN vs NaN: dirty
            x[600], p[600] = -0.0, 0.0                 # -0 vs +0: clean
        yield f"float32 n={n} sparse+specials", x, p, 256
        yield f"float32 n={n} clean", x, x.clone(), 256


def check_kernel(dev: str) -> int:
    """Every case exactly equal to the plain version; returns the largest
    absolute difference of the masks (0)."""
    max_err = 0
    n_cases = 0
    for label, x, p, be in _kernel_cases(dev):
        got = dirty_block_mask(x, p, block_elems=be)
        torch.cuda.synchronize()
        want = dirty_block_mask_reference(x, p, be)
        # a clean pair has no dirt, unless it holds NaN (never equal to itself)
        has_nan = x.is_floating_point() and bool(torch.isnan(x).any())
        if "clean" in label and not has_nan and bool(want.any()):
            raise AssertionError(f"{label}: the plain version reports dirt in a clean pair")
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label}: kernel gave {got.shape}/{got.dtype}, "
                                 f"plain {want.shape}/{want.dtype}")
        err = int((got - want).abs().max()) if got.numel() else 0
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel mask differs from the plain version "
                                 f"in {int((got != want).sum())} blocks")
        max_err = max(max_err, err)
        n_cases += 1
    log(f"[kernel] delta_snapshot equals its plain version exactly in {n_cases} cases")
    return max_err


def time_kernel(dev: str) -> dict:
    nbytes = DEPLOY_GRID * DEPLOY_GRID * 4
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, 256, (nbytes,), generator=gen, device=dev, dtype=torch.uint8)
    p = x.clone()
    p[torch.randint(0, nbytes, (nbytes // 4096,), generator=gen, device=dev)] += 1
    ms = cuda_ms(lambda: dirty_block_mask(x, p, block_elems=BLOCK_BYTES))
    plain_ms = cuda_ms(lambda: dirty_block_mask_reference(x, p, BLOCK_BYTES))
    bound = delta_bound_ms(nbytes, BLOCK_BYTES)
    log(f"[kernel] delta_snapshot at {nbytes} bytes, {BLOCK_BYTES}-byte blocks: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({bound / ms:.1%} of the bound)")
    del x, p
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound}


# ------------------------------------------------------------ 3. characterize
def _campaign_entry(app) -> dict:
    """The pinned campaign (8 tests, seed 123, no plan) as the goldens file
    keeps it."""
    with open(GOLDENS) as f:
        cfg = json.load(f)["config"]
    camp = CrashTester(app, PersistPlan.none(), default_cache(app),
                       seed=cfg["seed"]).run_campaign(cfg["n_tests"])
    counts = {c: 0 for c in ("S1", "S2", "S3", "S4")}
    for r in camp.records:
        counts[r.outcome] += 1
    return {"counts": counts, "golden_iters": camp.golden_iters,
            "crash_iters": [r.iter_idx for r in camp.records]}


def _check_pin(name: str, app, tag: str = "characterize") -> None:
    with open(GOLDENS) as f:
        want = json.load(f)["apps"][name]
    t0 = time.perf_counter()
    got = _campaign_entry(app)
    log(f"[{tag}] {name} campaign on {app.device}: {got} in {time.perf_counter() - t0:.1f} s")
    if got != want:
        raise AssertionError(f"{name} campaign differs from its golden {want}")


def _workflow_plan(name: str, app, tag: str = "characterize") -> PersistPlan:
    t0 = time.perf_counter()
    plan = run_workflow(app, WorkflowConfig(n_tests=24, cache=default_cache(app), seed=0)).plan
    log(f"[{tag}] {name} run_workflow plan on {app.device}: {plan} in "
        f"{time.perf_counter() - t0:.1f} s")
    return plan


def phase_characterize(dev: str) -> PersistPlan:
    app = ci_app("sor", device=dev)
    _check_pin("sor", app)
    plan = _workflow_plan("sor", app)
    if (plan.objects, plan.region_freq) != JAX_SOR_PLAN:
        raise AssertionError(f"plan differs from the JAX plan {JAX_SOR_PLAN}")

    # information only: one sweep pair on the card against the same on the CPU
    rng = np.random.default_rng(0)
    u = rng.standard_normal(app.grid ** 2).astype(np.float32)
    b = app.init(0)["b"]
    on_cpu = _rb_sor(torch.from_numpy(u), torch.from_numpy(b), app.grid, app.omega, 1)
    on_dev = _rb_sor(torch.from_numpy(u).to(dev), torch.from_numpy(b).to(dev),
                     app.grid, app.omega, 1).cpu()
    log(f"[characterize] one sweep pair, card vs CPU: max |diff| "
        f"{float((on_dev - on_cpu).abs().max()):.3e}, bitwise {torch.equal(on_dev, on_cpu)}")
    return plan


# ------------------------------------------------------------------ 4. deploy
def _energy(u: torch.Tensor, b: torch.Tensor, g: int) -> float:
    """E(u) = u'Au/2 - b'u in float64.  SOR with 0 < omega < 2 lowers it at
    every half sweep (it is the error's A-norm up to a constant); the
    residual norm is not monotone while the iteration is young."""
    u64, b64 = u.double(), b.double()
    return float(0.5 * torch.dot(u64, laplacian_apply(u64, g)) - torch.dot(b64, u64))


def _same_bytes(img: np.ndarray, live: torch.Tensor) -> bool:
    dev_img = torch.from_numpy(np.ascontiguousarray(img)).to(live.device)
    return (dev_img.shape == live.shape and dev_img.dtype == live.dtype
            and torch.equal(dev_img.view(torch.uint8), live.view(torch.uint8)))


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def deploy(dev: str, name: str, app, plan: PersistPlan, label: str,
           restore_verify=None, extra=None, flush_after=None) -> dict:
    """The app under ``EasyCrashManager`` with ``plan``'s objects and delta
    flushes: DEPLOY_ITERS iterations, each flushed (the first flush writes
    all, the others take their masks from ``delta_snapshot``; every image
    must equal the live bytes, and every flush write the blocks the plain
    mask names), a crash, a restore from the arena (its objects equal to the
    last flushed bytes), AFTER_RESTORE_ITERS more iterations, each flushed
    through the kernel against the shadow the restore left.

    ``flush_after`` names the regions after which every iteration flushes
    (the plan's region frequencies, each 1; both flushes of iteration k
    carry step k); None flushes once, at the end of every iteration.
    ``restore_verify(state, step)`` is the restore's acceptance hook (None
    accepts); ``extra`` is (name, fn(state) -> float, check(values) -> bool),
    a metric recorded at the restore and after each later iteration, whose
    values must pass the check."""
    t0 = time.perf_counter()
    state = state_to_torch(app.init(0), dev)
    obj_bytes = {n: state[n].numel() * state[n].element_size() for n in plan.objects}
    points = tuple(flush_after) if flush_after else (None,)
    regions = app.regions()
    where = ("at the end of every iteration" if points == (None,) else
             "after " + " and ".join(regions[i].name for i in points) + " in every iteration")
    log(f"[deploy {name}] {label}: flushes {obj_bytes} bytes on {dev} {where}; "
        f"init {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arena = NVMArena(BLOCK_BYTES)
    policy = FlushPolicy(leaves=plan.objects, every_steps=1, async_flush=False,
                         persist_mode="delta")
    mgr = EasyCrashManager(arena, policy)
    rec = {"flush_s": [], "splits": [], "steady": None, "prev": None, "prev_step": None}

    def iterate(state, on_flush):
        """One iteration, flushing at each point; returns the state and the
        seconds spent computing (flushes excluded)."""
        spent = 0.0
        steps = ((None, app.run_iteration),) if points == (None,) else \
            tuple((i, r.fn) for i, r in enumerate(regions))
        for i, fn in steps:
            t0 = time.perf_counter()
            state = fn(state)
            torch.cuda.synchronize()
            spent += time.perf_counter() - t0
            if i in points:
                on_flush(i, state)
        return state, spent

    def checked_flush(step, point, state):
        expect = None
        if rec["prev"] is not None:  # the plain version's count of dirty blocks
            expect = int(step != rec["prev_step"]) + sum(  # + the __step__ leaf's block
                int(dirty_block_mask_reference(_u8(state[n]), _u8(rec["prev"][n]),
                                               BLOCK_BYTES).sum())
                for n in plan.objects)
        before = mgr.stats.blocks_written
        parts = [getattr(mgr.stats, k) for k in SPLIT_KEYS]
        t0 = time.perf_counter()
        if not mgr.maybe_flush(step, state):
            raise AssertionError(f"{name} step {step}: the plan's cadence flushes every step")
        rec["flush_s"].append((point, time.perf_counter() - t0))
        rec["splits"].append([getattr(mgr.stats, k) - v for k, v in zip(SPLIT_KEYS, parts)])
        written = mgr.stats.blocks_written - before
        if expect is not None and written != expect:
            raise AssertionError(f"{name} step {step}: flush wrote {written} blocks, "
                                 f"the plain mask says {expect}")
        for n in plan.objects:
            if not _same_bytes(arena.peek(n), state[n]):
                raise AssertionError(f"{name} step {step}: arena image of {n!r} != live bytes")
        if int(arena.get("__step__")) != step:
            raise AssertionError(f"{name} step {step}: arena step is "
                                 f"{int(arena.get('__step__'))}")
        if rec["steady"] is None:
            rec["steady"] = dict(vars(mgr.stats))
        rec["prev"] = {n: state[n].clone() for n in plan.objects}
        rec["prev_step"] = step

    iter_s = []
    for step in range(1, DEPLOY_ITERS + 1):
        state, spent = iterate(state, lambda i, s, step=step: checked_flush(step, i, s))
        iter_s.append(spent)
    peak = torch.cuda.max_memory_allocated()
    flush_s, steady, prev = rec["flush_s"], rec["steady"], rec["prev"]
    n_delta = len(flush_s) - 1
    st = vars(mgr.stats)
    split = {k: (st[k] - steady[k]) / n_delta * 1e3 for k in SPLIT_KEYS}
    out = {
        "plan": label,
        "objects": list(plan.objects),
        "object_bytes": obj_bytes,
        "ms_per_iter": float(np.mean(iter_s)) * 1e3,
        "ms_first_iter": iter_s[0] * 1e3,
        "ms_per_iter_after_first": float(np.mean(iter_s[1:])) * 1e3,
        "ms_first_flush": flush_s[0][1] * 1e3,
        "ms_per_flush": float(np.mean([s for _, s in flush_s[1:]])) * 1e3,
        "flush_split_ms": split,
        "bytes_written": mgr.stats.bytes_written,
        "bytes_first_flush": steady["bytes_written"],
        "bytes_per_flush": (st["bytes_written"] - steady["bytes_written"]) / n_delta,
        "peak_device_bytes": peak,
    }
    if points != (None,):
        out["flushes_per_iter"] = len(points)
        out["ms_per_flush_by_region"] = {
            regions[i].name: float(np.mean([s for p, s in flush_s[1:] if p == i])) * 1e3
            for i in points}
        out["flush_split_ms_by_region"] = {
            regions[i].name: dict(zip(SPLIT_KEYS, (np.mean(
                [sp for (p, _), sp in zip(flush_s[1:], rec["splits"][1:]) if p == i],
                axis=0) * 1e3).tolist()))
            for i in points}
    log(f"[deploy {name}] {DEPLOY_ITERS} iterations: {out['ms_per_iter']:.2f} ms/iteration "
        f"(the first {out['ms_first_iter']:.2f}, the rest {out['ms_per_iter_after_first']:.2f}), "
        f"first flush (full write) {out['ms_first_flush']:.1f} ms, then "
        f"{out['ms_per_flush']:.1f} ms/flush (mask {split['mask_seconds']:.1f}, "
        f"device-to-host {split['copy_seconds']:.1f}, arena {split['arena_seconds']:.1f} ms)"
        + (f", by region {out['flush_split_ms_by_region']}" if points != (None,) else ""))
    log(f"[deploy {name}] bytes written {out['bytes_written']} "
        f"({out['bytes_per_flush']:.0f} per delta flush), peak device memory {peak} bytes")

    # crash: the live state is gone; a new manager restores from the arena
    del state
    mgr.close()
    fresh = state_to_torch(app.init(0), dev)
    mgr = EasyCrashManager(arena, policy)
    restored, step, source = mgr.restore(fresh, verify=restore_verify)
    del fresh
    if source != "easycrash" or step != DEPLOY_ITERS:
        raise AssertionError(f"{name}: restore gave source={source!r} step={step}")
    for n in plan.objects:
        if restored[n].device != prev[n].device or not torch.equal(_u8(restored[n]),
                                                                    _u8(prev[n])):
            raise AssertionError(f"{name}: restored {n!r} differs from the last flushed bytes")
    progress = [app.progress(restored)]
    extras = [extra[1](restored)] if extra else []

    def restarted_flush(step, point, state):
        # the restarted run flushes on: the restore left the manager a shadow
        # of each object on the card, so this delta mask comes from the kernel
        launches = dirty_block_mask.launches
        if not mgr.maybe_flush(step, state):
            raise AssertionError(f"{name} step {step}: no flush after the restore")
        if dirty_block_mask.launches != launches + len(plan.objects):
            raise AssertionError(f"{name} step {step}: the flush after the "
                                 f"restore did not launch delta_snapshot")
        for n in plan.objects:
            if not _same_bytes(arena.peek(n), state[n]):
                raise AssertionError(f"{name} step {step}: arena image of {n!r} "
                                     f"!= live bytes")

    state = restored
    for k in range(1, AFTER_RESTORE_ITERS + 1):
        state, _ = iterate(state, lambda i, s, step=DEPLOY_ITERS + k: restarted_flush(step, i, s))
        progress.append(app.progress(state))
        if extra:
            extras.append(extra[1](state))
    if not all(np.isfinite(progress)):
        raise AssertionError(f"{name}: the progress metric after the restore is not finite: "
                             f"{progress}")
    if extra and not extra[2](extras):
        raise AssertionError(f"{name}: {extra[0]} after the restore failed its check: {extras}")
    out["progress_after_restore"] = progress
    if extra:
        out[f"{extra[0]}_after_restore"] = extras
    log(f"[deploy {name}] restored step {step} from the arena (source={source}), objects "
        f"equal to the last flushed bytes; {AFTER_RESTORE_ITERS} more iterations, each flush "
        f"through the kernel: progress {progress}"
        + (f", {extra[0]} {extras}" if extra else ""))
    mgr.close()
    del state, restored, prev
    rec.clear()
    torch.cuda.empty_cache()
    return out


#: the parts of a flush that ManagerStats times
SPLIT_KEYS = ("mask_seconds", "copy_seconds", "arena_seconds")


def delta_launches_expected(plan: PersistPlan, flushes_per_iter: int = 1) -> int:
    """One ``delta_snapshot`` launch per object and delta flush: every flush
    but the first (a full write) of DEPLOY_ITERS iterations, and every flush
    of AFTER_RESTORE_ITERS more."""
    return (flushes_per_iter * (DEPLOY_ITERS + AFTER_RESTORE_ITERS) - 1) * len(plan.objects)


def phase_deploy(dev: str, plan: PersistPlan, label: str = "run_workflow's plan",
                 app=None) -> dict:
    app = app if app is not None else SORApp(grid=DEPLOY_GRID, device=dev)
    g = app.grid
    fresh = app.init(0)
    e_fresh = _energy(torch.from_numpy(fresh["u"]).to(dev), torch.from_numpy(fresh["b"]).to(dev), g)

    def energy(s):
        return _energy(s["u"], s["b"], g)

    return deploy(dev, "sor", app, plan, label,
                  restore_verify=lambda s, k: energy(s) < e_fresh,
                  extra=("energy", energy, lambda v: all(b < a for a, b in zip(v, v[1:]))))


# --------------------------------------------------------- 5. flash attention
def _flash_cases():
    """(label, shape (B,S,H,D), dtype, causal, window, block, kv heads)."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128, 256):
            for causal, window in ((True, None), (False, None), (True, 64), (True, 128),
                                   (False, 64)):
                for s in (128, 256, 512):
                    for blk in (64, 128):
                        yield (f"{dtype} D={d} S={s} blk={blk} causal={causal} window={window}",
                               (1, s, 2, d), dtype, causal, window, blk, 2)
        yield f"{dtype} ragged S=100", (2, 100, 3, 64), dtype, True, None, 128, 3
    # the bf16 route's edges: windows under its kv tile (128 rows at D 64 and
    # 128, 64 at D 256), so rows of a live tile are wholly masked; a
    # non-causal window; ragged S at every D; a q tile's second warpgroup
    # wholly past S (S 64)
    for d in (64, 128, 256):
        for causal, window in ((True, 8), (True, 32), (True, 48), (False, 40), (False, 8)):
            yield (f"bf16 route D={d} S=256 causal={causal} window={window}",
                   (2, 256, 2, d), torch.bfloat16, causal, window, 128, 2)
        for s, blk in ((100, 128), (64, 64), (192, 64)):
            yield (f"bf16 route D={d} ragged S={s}", (2, s, 3, d), torch.bfloat16, True, None,
                   blk, 3)
        yield (f"bf16 route D={d} S=512 non-causal", (1, 512, 2, d), torch.bfloat16,
               False, None, 128, 2)
    for path, (shape, hkv, window) in ATTN_PATHS.items():
        yield f"{path} shape", shape, torch.bfloat16, True, window, 128, hkv


def _attn_inputs(gen, shape, hkv: int, dtype, repeat: bool = True):
    """q (B,S,H,D); k and v drawn with ``hkv`` heads and (``repeat``)
    repeated to H as attention_full repeats them before the kernel."""
    b, s, h, d = shape
    q = torch.randn(shape, generator=gen, device=gen.device).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=gen.device).to(dtype)
            for _ in range(2))
    if repeat:
        k, v = _repeat_kv(k, h // hkv), _repeat_kv(v, h // hkv)
    return q, k, v


def _check_masked_rows(gen) -> None:
    """Causal window 8 under the bf16 route's kv tile: each row's 8 keys,
    and no weight from the wholly masked rows of the live tiles around
    them, against a float64 softmax over exactly those keys (2e-2, the
    bf16 tolerance)."""
    for d in (64, 256):
        q, k, v = (torch.randn(1, 256, 1, d, generator=gen, device=gen.device)
                   .to(torch.bfloat16) for _ in range(3))
        got = flash_attention(q, k, v, causal=True, window=8, block_q=64, block_k=64)
        qs, ks, vs = (x[0, :, 0].double() for x in (q, k, v))
        for i in (0, 7, 8, 63, 64, 100, 127, 128, 135, 255):
            lo = max(0, i - 7)
            w = torch.softmax((qs[i] @ ks[lo:i + 1].T) * d ** -0.5, dim=0)
            want = (w @ vs[lo:i + 1]).float()
            if not torch.allclose(got[0, i, 0].float(), want, atol=2e-2, rtol=2e-2):
                raise AssertionError(f"flash_attention bf16 D={d} window 8: row {i} differs "
                                     f"from its 8 keys' softmax by "
                                     f"{float((got[0, i, 0].float() - want).abs().max()):.3e}")
    log("[flash] bf16 rows wholly masked inside live kv tiles take no weight (window 8, "
        "D 64 and 256)")


def attn_bound_ms(b: int, s: int, h: int, d: int, window=None) -> tuple:
    """Least time for causal attention: max of the FLOPs (two products over
    the (query, key) pairs the causal window keeps, 4 B H D per pair) at the
    bf16 tensor-core rate and the bytes (q, k, v as the kernel takes them,
    repeated to H heads, read once, out written once, 2 bytes each) at the
    device-memory rate."""
    w = s if window is None else min(window, s)
    pairs = w * (w + 1) / 2 + (s - w) * w
    flops = 4 * b * h * d * pairs
    nbytes = 4 * b * s * h * d * 2
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _time_flash(gen, path: str) -> dict:
    """Kernel, plain version and SDPA at one path's prefill shape, on k and v
    as the kernel reads them (contiguous, repeated to H heads); and the op as
    the path calls it (``path_ms``): ``_repeat_kv`` of the kv heads, which
    copies them to H heads (GQA), or gives a stride-0 view for one kv head
    that the wrapper copies, then the kernel."""
    shape, hkv, window = ATTN_PATHS[path]
    bsz, s, h, d = shape
    q, k1, v1 = _attn_inputs(gen, shape, hkv, torch.bfloat16, repeat=False)
    path_ms = cuda_ms(lambda: flash_attention(q, _repeat_kv(k1, h // hkv),
                                              _repeat_kv(v1, h // hkv), causal=True,
                                              window=window))
    k, v = (_repeat_kv(x, h // hkv).contiguous() for x in (k1, v1))
    del k1, v1
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=window))
    plain_ms = cuda_ms(lambda: attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                                                   v.transpose(1, 2), causal=True,
                                                   window=window))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if window is not None and window < s:
        i = torch.arange(s, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=mask is None))
    bound, bound_by = attn_bound_ms(bsz, s, h, d, window)
    log(f"[flash] flash_attention at the {path} shape B={bsz} S={s} H={h} (kv {hkv}) D={d} "
        f"bf16 causal window={window}: kernel {ms:.4f} ms, as the path calls it {path_ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound:.4f} ms "
        f"({bound_by}; {bound / ms:.1%} of the bound)")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"shape": list(shape), "kv_heads": hkv, "window": window, "ms": ms,
            "path_ms": path_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": bound_by}


def phase_flash(dev: str) -> dict:
    """Kernel against plain version: 2e-5 (abs and rel) in float32, 2e-2 in
    bfloat16 (tests/test_kernels.py's tolerances); tile independence to
    1e-5; then both paths' shapes timed.  The StableLM shape's numbers are
    the kernel's headline ones, as in earlier runs."""
    gen = torch.Generator(device=dev).manual_seed(3)
    max_err, n = 0.0, 0
    for label, shape, dtype, causal, window, blk, hkv in _flash_cases():
        q, k, v = _attn_inputs(gen, shape, hkv, dtype)
        got = flash_attention(q, k, v, causal=causal, window=window, block_q=blk, block_k=blk)
        torch.cuda.synchronize()
        want = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, window=window).transpose(1, 2)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention {label}: max |kernel - plain| {err:.3e} "
                                 f"over the tolerance {tol}")
        max_err, n = max(max_err, err), n + 1
    q, k, v = (torch.randn(1, 256, 2, 64, generator=gen, device=dev) for _ in range(3))
    a = flash_attention(q, k, v, block_q=32, block_k=32)
    b = flash_attention(q, k, v, block_q=128, block_k=128)
    tile_err = float((a - b).abs().max())
    if tile_err > 1e-5:
        raise AssertionError(f"flash_attention: kv tiles 32 and 64 differ by {tile_err:.3e}")
    log(f"[flash] flash_attention within tolerance of its plain version in {n} cases "
        f"(max |diff| {max_err:.3e}); kv tiles 32 vs 64 differ by {tile_err:.3e}")
    _check_masked_rows(gen)
    for path, (shape, hkv, window) in ATTN_PATHS.items():
        q, k, v = _attn_inputs(gen, shape, hkv, torch.bfloat16)
        a = flash_attention(q, k, v, causal=True, window=window)
        b = flash_attention(q, k, v, causal=True, window=window)
        if not torch.equal(a, b):
            raise AssertionError(f"flash_attention: two bf16 launches at the {path} shape differ "
                                 f"in {int((a != b).sum())} elements")
        del q, k, v, a, b
    log("[flash] two bf16 launches give the same bits at both paths' shapes")

    by_path = {path: _time_flash(gen, path) for path in ATTN_PATHS}
    head = by_path["serve_stablelm"]
    return {**{k: head[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "max_abs_err": max_err, "by_path": by_path}


# ----------------------------------------------------- 6. decode characterize
def phase_decode_characterize(dev: str) -> None:
    app = ci_app("decode", device=dev)
    _check_pin("decode", app, tag="decode")
    plan = _workflow_plan("decode", app, tag="decode")
    if (plan.objects, plan.region_freq) != JAX_DECODE_PLAN:
        raise AssertionError(f"plan differs from the JAX plan {JAX_DECODE_PLAN}")


# ------------------------------------------------------------------- 7. serve
def _serve_args(workdir: str, inject: int = 0, arch: str = SERVE_ARCH) -> argparse.Namespace:
    return serve.parser().parse_args([
        "--arch", arch, "--full-size", "--prompts", str(SERVE_PROMPTS),
        "--prompt-len", str(SERVE_PROMPT_LEN), "--decode-steps", str(SERVE_STEPS),
        "--flush-every", str(SERVE_FLUSH_EVERY), "--workdir", workdir,
        "--inject-failure-at", str(inject),
    ])


def _check_images(step: int, state: dict, arena: NVMArena) -> None:
    """Every flushed image (each leaf of the cache, and the tokens) equals
    the live bytes."""
    for name, live in flatten_state(state).items():
        img = arena.peek(name)
        if img is None or img.tobytes() != host_array(live).tobytes():
            raise AssertionError(f"step {step}: arena image of {name!r} != live bytes")


def phase_serve(dev: str) -> dict:
    cfg = get_arch(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(int(x.numel()) for x in _leaves(params))
    log(f"[serve] {SERVE_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters in {cfg.dtype}, init {time.perf_counter() - t0:.1f} s")
    prompts = serve.make_prompts(cfg, SERVE_PROMPTS, SERVE_PROMPT_LEN, dev)

    # the kernel prefill against the reference prefill (not the counted run).
    # In float32 weights the two differ only in the order of sums: held to
    # 2e-2.  In bfloat16 they differ by design as well (the reference rounds
    # the softmax weights to bf16 before the product with v, the kernel
    # keeps them f32, as JAX's Pallas path does), and 24 layers carry that
    # difference on: printed, with the greedy tokens.
    per_prefill = {}
    for name, p in (("float32", _tree_map(params, lambda x: x.float())), ("bfloat16", params)):
        c = dataclasses.replace(cfg, dtype=name)
        before = flash_attention.launches
        lk, _ = prefill(c, p, prompts, impl="kernel")
        per_prefill[name] = flash_attention.launches - before
        lr, _ = prefill(c, p, prompts, impl="reference")
        torch.cuda.synchronize()
        err = float((lk.float() - lr.float()).abs().max())
        same = torch.equal(lk.argmax(-1), lr.argmax(-1))
        log(f"[serve] {name} weights: kernel vs reference prefill logits {tuple(lk.shape)}: "
            f"max |diff| {err:.3e} (|logit| up to {float(lr.float().abs().max()):.2f}); "
            f"greedy tokens equal: {same}")
        if name == "float32" and not torch.allclose(lk, lr, atol=2e-2, rtol=2e-2):
            raise AssertionError("float32 kernel prefill logits differ from the reference's "
                                 "beyond 2e-2")
        del p, lk, lr
        torch.cuda.empty_cache()
    if set(per_prefill.values()) != {cfg.n_layers}:
        raise AssertionError(f"a prefill launched flash_attention {per_prefill} times, "
                             f"not once per layer ({cfg.n_layers})")

    # the kernel prefill alone and warm, beside serve.run's prefill_ms below
    # (which also allocates and fills the decode cache)
    warm_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(cfg, params, prompts, impl="kernel")
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[serve] kernel prefill alone, warm: {', '.join(f'{x:.1f}' for x in warm_ms)} ms")

    profile = _profile_decode(cfg, params, prompts, dev)
    torch.cuda.empty_cache()

    shutil.rmtree(SERVE_WORKDIR, ignore_errors=True)
    try:
        flash_attention.launches = 0
        dirty_block_mask.launches = 0
        torch.cuda.reset_peak_memory_stats()
        clean = serve.run(_serve_args(os.path.join(SERVE_WORKDIR, "clean")), params=params,
                          prompts=prompts, on_flush=_check_images)
        crash_dir = os.path.join(SERVE_WORKDIR, "crash")
        try:
            serve.run(_serve_args(crash_dir, SERVE_CRASH_AT), params=params, prompts=prompts,
                      on_flush=_check_images)
            raise AssertionError("the injected failure did not fire")
        except serve.SimulatedFailure as e:
            log(f"[serve] {e}; restarting from the arena")
        resumed = serve.run(_serve_args(crash_dir), params=params, prompts=prompts,
                            on_flush=_check_images)
        flash_launches = flash_attention.launches
        delta_launches = dirty_block_mask.launches
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(SERVE_WORKDIR, ignore_errors=True)
    if not resumed["resumed"] or resumed["decode_steps"] != SERVE_STEPS - SERVE_CRASH_AT:
        raise AssertionError(f"the restart did not resume at step {SERVE_CRASH_AT}")
    if not np.array_equal(resumed["tokens"], clean["tokens"]):
        diff = np.argwhere(resumed["tokens"] != clean["tokens"])
        raise AssertionError(f"the resumed stream differs from the uninterrupted one at {diff[:4]}")
    # 2 prefills (the uninterrupted run, the crashed run); the resume has none
    if flash_launches != 2 * cfg.n_layers:
        raise AssertionError(f"flash_attention launched {flash_launches} times, "
                             f"expected {2 * cfg.n_layers}")
    _check_delta_launches("serve", cfg, delta_launches)
    _check_kv_flush_bytes("serve", cfg, clean["flush_bytes"][1:] + resumed["flush_bytes"])
    row = cfg.n_kv_heads * cfg.head_dim * 2  # one token's K (or V) in one layer, bf16
    n_flush = len(clean["flush_bytes"])
    split = clean["flush_split_ms"]
    out = {
        "prefill_ms": clean["prefill_ms"],
        "prefill_warm_ms": warm_ms,
        "decode_ms_per_step": clean["decode_ms_per_step"],
        "tokens_per_s": clean["tokens_per_s"],
        "flush_ms_mean": clean["flush_ms"] / n_flush,
        "flush_split_ms_mean": {k: v / n_flush for k, v in split.items()},
        "flush_bytes": clean["flush_bytes"],
        "resumed_flush_bytes": resumed["flush_bytes"],
        "kv_cache_bytes_per_leaf": cfg.n_layers * SERVE_PROMPTS * (SERVE_PROMPT_LEN +
                                                                   SERVE_STEPS + 1) * row,
        "peak_device_bytes": peak,
        "flash_launches": flash_launches,
        "delta_launches": delta_launches,
        "decode_profile": profile,
        # what serve.fleet_report reads of a run's stats (phase 16)
        "fleet_stats": {k: clean[k] for k in ("decode_steps", "tokens_per_s", "bytes_written")},
    }
    log(f"[serve] prefill {out['prefill_ms']:.1f} ms, decode {out['decode_ms_per_step']:.2f} "
        f"ms/step, flush {out['flush_ms_mean']:.1f} ms mean of {n_flush} (mask "
        f"{out['flush_split_ms_mean']['mask_seconds']:.1f}, device-to-host "
        f"{out['flush_split_ms_mean']['copy_seconds']:.1f}, arena "
        f"{out['flush_split_ms_mean']['arena_seconds']:.1f} ms); bytes per flush "
        f"{clean['flush_bytes']}, after the resume {resumed['flush_bytes']}")
    log(f"[serve] resumed stream equals the uninterrupted one ({resumed['tokens'].shape}); "
        f"launches: flash_attention {flash_launches}, delta_snapshot {delta_launches}; "
        f"peak device memory {peak} bytes")
    return out


def _check_kv_flush_bytes(name: str, cfg, later: list) -> None:
    """Each delta flush after the first writes the KV rows of the steps since
    the last one, in k and in v of every layer and session (bf16), plus a
    few blocks of tokens, t and the step."""
    row = cfg.n_kv_heads * cfg.head_dim * 2  # one token's K (or V) in one layer
    kv_bytes = 2 * SERVE_FLUSH_EVERY * cfg.n_layers * SERVE_PROMPTS * row
    if not all(kv_bytes < b <= kv_bytes + 64 * 16 for b in later):
        raise AssertionError(f"{name}: delta flushes wrote {later} bytes, expected {kv_bytes} "
                             f"of KV rows plus a few token blocks")


def _kernel_profile(fn, steps: int) -> dict:
    """``fn()`` run ``steps`` times under torch.profiler: the host-clock wall
    time (synchronized), the CUDA kernels' self time, the device's idle
    share, the kernels that take the most device time, and the share of
    matrix products (cuBLAS/CUTLASS kernels) in the device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # kernels only: an op's row repeats the time of the kernels it launched
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    gemm = re.compile(r"gemm|xmma|cutlass|nvjet", re.I)  # cuBLAS's and CUTLASS's names
    gemm_ms = sum(ms for ms, name, _ in rows if gemm.search(name))
    return {"steps": steps, "wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": (1 - device_ms / wall_ms) if device_ms else None,
            "gemm_share": (gemm_ms / device_ms) if device_ms else None,
            "top": [(name[:60], round(ms, 3), n) for ms, name, n in rows[:6]]}


def _profile_decode(cfg, params, prompts, dev: str, steps: int = 8, name: str = "serve") -> dict:
    """Device time of ``steps`` decode steps against their wall time: the
    device's idle share, and the kernels that take the most device time."""
    logits, pcache = prefill(cfg, params, prompts, impl="kernel")
    max_len = SERVE_PROMPT_LEN + steps + 1
    cache = serve._splice_cache(cfg, init_cache(cfg, SERVE_PROMPTS, max_len, dev), pcache,
                                SERVE_PROMPT_LEN)
    step_fn = make_decode_fn(cfg)
    box = {"token": logits.argmax(dim=-1).to(torch.int32)[:, None], "cache": cache}
    del logits, pcache

    def one():
        box["token"], box["cache"], _ = step_fn(params, box["cache"], box["token"])

    one()  # warm-up
    out = _kernel_profile(one, steps)
    if out["device_ms"]:
        log(f"[{name}] profile of {steps} decode steps: wall {out['wall_ms']:.1f} ms, device "
            f"{out['device_ms']:.1f} ms, idle share {out['idle_share']:.1%}; top kernels (ms, "
            f"launches): {out['top']}")
    else:
        log(f"[{name}] profile of decode steps: the profiler reported no device time "
            "(idle share not measured)")
    return out


# ------------------------------------------------------- 8. recurrent kernels
def _check_close(label: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    err = float((got.float() - want.float()).abs().max())
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"{label}: kernel gave {tuple(got.shape)}/{got.dtype}, "
                             f"plain {tuple(want.shape)}/{want.dtype}")
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{label}: max |kernel - plain| {err:.3e} over the tolerance {tol}")
    return err


def _rwkv_inputs(gen, shape, dtype, model_decay=False):
    """r, k, v (normals times 0.5), w and u (H, D) as tests/test_kernels.py
    draws them; with ``model_decay`` w is RWKV6-3B's own decay,
    exp(-exp(-6 + 0.3 n)), about 0.9975 a step."""
    b, s, h, d = shape
    r, k, v = (torch.randn(shape, generator=gen, device=gen.device) * 0.5 for _ in range(3))
    n = torch.randn(shape, generator=gen, device=gen.device)
    w = torch.exp(-torch.exp(-6.0 + 0.3 * n)) if model_decay else torch.sigmoid(n)
    u = torch.randn((h, d), generator=gen, device=gen.device) * 0.3
    return [x.to(dtype) for x in (r, k, v, w)] + [u]


def _rwkv_plain(r, k, v, w, u, return_state=False):
    y, S = rwkv6_reference(*(x.transpose(1, 2) for x in (r, k, v, w)), u, return_state=True)
    return (y.transpose(1, 2), S) if return_state else y.transpose(1, 2)


def scan_ptxas(name: str) -> dict:
    """Registers, stack and spills of each kernel of ``csrc/<name>.cu`` from
    the ptxas report of its build (``-Xptxas -v``, kept beside the library);
    {} if no report was kept."""
    text = _build.BUILD_LOGS.get(name, "")
    out, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\S*?(rwkv6_scan_kernel|rglru_scan_ring|"
                      r"rglru_scan_direct)I(f|13__nv_bfloat16)E?(?:Li(\d+)E)?", line)
        vec = re.search(r"Compiling entry function '\S*?ssm_update_kernelILi(\d+)E", line)
        if m:
            kernel, t, d = m.groups()
            key = f"{kernel} {'f32' if t == 'f' else 'bf16'}" + (f" D={d}" if d else "")
            out[key] = {}
        elif vec:
            key = f"ssm_update_kernel kVec={vec.group(1)}"
            out[key] = {}
        elif key and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[key].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif key and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def _check_ptxas(name: str) -> dict:
    info = scan_ptxas(name)
    for kernel, v in info.items():
        log(f"[{name}] ptxas {kernel}: {v}")
    spilled = {k: v for k, v in info.items() if v.get("spill_stores") or v.get("spill_loads")}
    if spilled:
        raise AssertionError(f"{name}: ptxas reports spills in {spilled}")
    if not info:
        log(f"[{name}] no ptxas report kept for this library")
    return info


def rwkv_bound_ms(b: int, s: int, h: int, d: int) -> tuple:
    """Least time for the scan: max of the bytes (r, k, v, w f32 read once,
    y f32 written once) at the device-memory rate and the function's f32
    work at the f32 CUDA-core rate.  The work per token and head: r.S and
    S <- w*S + k'v, 5 FLOP per state element; the bonus r.(u*k'v) is
    v_j * sum_i r_i u_i k_i, 5 FLOP per channel."""
    nbytes = 5 * b * s * h * d * 4 + h * d * 4
    flops = 5 * b * s * h * d * (d + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def phase_rwkv_kernel(dev: str) -> dict:
    """Kernel against plain version to 1e-4 (abs and rel; both upcast to f32
    and differ in the order of sums) over f32 and bf16 inputs, D 16, 32, 64
    and block_t 32, 64, 256; the final state too, at a length off the
    kernel's 16-token chunk; the result independent of block_t and of
    return_state, and the same bits on a second launch; the path's shape
    with the model's decay, output and state; then the path's call
    (with the state) timed."""
    gen = torch.Generator(device=dev).manual_seed(5)
    max_err, state_err, n = 0.0, 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 32, 64):
            for bt in (32, 64, 256):
                shape = (2, 256, 3, d)
                r, k, v, w, u = _rwkv_inputs(gen, shape, dtype)
                got = rwkv6_scan(r, k, v, w, u, block_t=bt)
                torch.cuda.synchronize()
                err = _check_close(f"rwkv6_scan {dtype} D={d} block_t={bt}", got,
                                   _rwkv_plain(r, k, v, w, u), 1e-4)
                max_err, n = max(max_err, err), n + 1
            r, k, v, w, u = _rwkv_inputs(gen, (2, 100, 3, d), dtype)
            y, S = rwkv6_scan(r, k, v, w, u, block_t=100, return_state=True)
            torch.cuda.synchronize()
            want_y, want_S = _rwkv_plain(r, k, v, w, u, return_state=True)
            max_err = max(max_err, _check_close(f"rwkv6_scan {dtype} D={d} T=100", y, want_y,
                                                1e-4))
            state_err = max(state_err, _check_close(f"rwkv6_scan {dtype} D={d} T=100 state", S,
                                                    want_S, 1e-4))
            n += 1
    r, k, v, w, u = _rwkv_inputs(gen, RWKV_SHAPE, torch.float32, model_decay=True)
    got, S = rwkv6_scan(r, k, v, w, u, return_state=True)
    torch.cuda.synchronize()
    want_y, want_S = _rwkv_plain(r, k, v, w, u, return_state=True)
    max_err = max(max_err, _check_close("rwkv6_scan path shape", got, want_y, 1e-4))
    state_err = max(state_err, _check_close("rwkv6_scan path shape state", S, want_S, 1e-4))
    del want_y, want_S
    if not torch.equal(got, rwkv6_scan(r, k, v, w, u, block_t=32)):
        raise AssertionError("rwkv6_scan: block_t 32 and 256 differ, or the output with the "
                             "state differs from the output without it")
    again, S_again = rwkv6_scan(r, k, v, w, u, return_state=True)
    if not (torch.equal(got, again) and torch.equal(S, S_again)):
        raise AssertionError("rwkv6_scan: two launches differ")
    log(f"[rwkv6] rwkv6_scan within 1e-4 of its plain version in {n + 1} cases (max |diff| "
        f"{max_err:.3e}; final state {state_err:.3e}); block_t 32 and 256, with and without "
        f"the state, and two launches: the same bits")
    ptxas = _check_ptxas("rwkv6_scan")

    ms = cuda_ms(lambda: rwkv6_scan(r, k, v, w, u, return_state=True))
    plain_ms = cuda_ms(lambda: _rwkv_plain(r, k, v, w, u, return_state=True), reps=5, warmup=1)
    bound, bound_by = rwkv_bound_ms(*RWKV_SHAPE)
    log(f"[rwkv6] rwkv6_scan at (B, S, H, D) = {RWKV_SHAPE} f32, with the final state: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
        f"{bound / ms:.1%} of the bound)")
    del r, k, v, w, u, got, S, again, S_again
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": max(max_err, state_err), "state_max_abs_err": state_err,
            "ptxas": ptxas}


def rglru_bound_ms(b: int, t: int, d: int) -> float:
    """Least time for the scan: a and b f32 read once, h f32 written once,
    at the device-memory rate (one multiply and one add per element is far
    under the f32 rate)."""
    return 3 * b * t * d * 4 / HBM_BYTES_PER_S * 1e3


def phase_rglru_kernel(dev: str) -> dict:
    """Kernel against plain version bit for bit (both round the product and
    the add one at a time) over f32 and bf16 inputs, block_d 64 and 128,
    block_t 64 and 256, a ragged length, rows off 16 bytes (D 75: the
    kernel's direct path) and the path's shape.  Then the path's shape
    timed."""
    gen = torch.Generator(device=dev).manual_seed(6)
    n = 0
    cases = [(dtype, (2, 256, 256), bt, bd) for dtype in (torch.float32, torch.bfloat16)
             for bt in (64, 256) for bd in (64, 128)]
    cases += [(dtype, shape, shape[1], bd) for dtype in (torch.float32, torch.bfloat16)
              for shape, bd in (((3, 64, 192), 64), ((2, 100, 256), 128), ((3, 50, 75), 75))]
    cases += [(torch.float32, RGLRU_SHAPE, 256, 128)]
    for dtype, shape, bt, bd in cases:
        a = (torch.sigmoid(torch.randn(shape, generator=gen, device=dev)) * 0.98).to(dtype)
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        got = rglru_scan(a, x, block_t=bt, block_d=bd)
        torch.cuda.synchronize()
        want = rglru_reference(a, x)
        if got.shape != want.shape or got.dtype != torch.float32 or not torch.equal(got, want):
            err = float((got.float() - want).abs().max()) if got.shape == want.shape else None
            raise AssertionError(f"rglru_scan {dtype} {shape} block_t={bt} block_d={bd}: not "
                                 f"bit for bit its plain version (max |diff| {err})")
        n += 1
    log(f"[rglru] rglru_scan equals its plain version bit for bit in {n} cases")
    ptxas = _check_ptxas("rglru_scan")
    ms = cuda_ms(lambda: rglru_scan(a, x))
    plain_ms = cuda_ms(lambda: rglru_reference(a, x), reps=5, warmup=1)
    bound = rglru_bound_ms(*RGLRU_SHAPE)
    log(f"[rglru] rglru_scan at (B, T, D) = {RGLRU_SHAPE} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes; {bound / ms:.1%} of the bound)")
    del a, x, got, want
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "max_abs_err": 0.0, "exact": True, "ptxas": ptxas}


# --------------------------------------------- 9, 10. serving recurrent models
@contextlib.contextmanager
def _patched(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` inside the block."""
    fn = getattr(module, name)
    setattr(module, name, wrap(fn))
    try:
        yield
    finally:
        setattr(module, name, fn)


def _recording(into: list, pick):
    """A wrapper for ``_patched`` that appends ``pick(result)`` of each call
    to ``into`` (device tensors: nothing waits on the host)."""
    def wrap(fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            into.append(pick(out))
            return out
        return recorded
    return wrap


def _greedy(cfg, params, logits, pcache, steps: int, split: int = 1, into=None):
    """``steps`` greedy decode steps from a prefill's logits and cache: the
    tokens (B, steps + 1), the prefill's own first.  ``split``: the heads
    of ``params`` are padded to it (models/padding.py); ``into``, a dict
    that takes the cache after the steps."""
    empty = init_cache(cfg, SERVE_PROMPTS, SERVE_PROMPT_LEN + steps + 1, logits.device.type)
    cache = serve._splice_cache(cfg, pad_cache(cfg, empty, split), pcache, SERVE_PROMPT_LEN)
    step_fn = make_decode_fn(cfg)
    tokens = [logits.argmax(dim=-1).to(torch.int32)[:, None]]
    for _ in range(steps):
        token, cache, _ = step_fn(params, cache, tokens[-1])
        tokens.append(token)
    if into is not None:
        into["cache"] = cache
    return torch.cat(tokens, dim=1)


def _compare_prefills(name: str, cfg, params, prompts, decode_steps: int = 0) -> dict:
    """The kernel prefill against the reference prefill in float32 weights:
    the two differ in the order of f32 sums only; held to 2e-2 (abs and
    rel), as the StableLM comparison.  On an MoE config the routers' top-k
    sets of the two are compared per (token, layer) and the ones that differ
    counted: a near tie that the order of sums flips.  With
    ``decode_steps``, each prefill's cache then decodes that many greedy
    steps, and the two streams must be equal."""
    c = dataclasses.replace(cfg, dtype="float32")
    p = _tree_map(params, lambda x: x.float())
    logits, routes, streams = {}, {}, {}
    for impl in ("kernel", "reference"):
        routes[impl] = []
        with _patched(moe, "_route", _recording(routes[impl], lambda out: out[1].sort(-1)[0])):
            logits[impl], pcache = prefill(c, p, prompts, impl=impl)
        if decode_steps:
            streams[impl] = _greedy(c, p, logits[impl], pcache, decode_steps)
        del pcache
    lk, lr = logits["kernel"], logits["reference"]
    torch.cuda.synchronize()
    err = float((lk - lr).abs().max())
    same = torch.equal(lk.argmax(-1), lr.argmax(-1))
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(routes["kernel"],
                                                             routes["reference"]))
    routed = sum(a.shape[0] for a in routes["kernel"])
    log(f"[{name}] float32 weights, {c.n_layers} layers: kernel vs reference prefill logits "
        f"{tuple(lk.shape)}: max |diff| {err:.3e} (|logit| up to {float(lr.abs().max()):.2f}); "
        f"greedy tokens equal: {same}"
        + (f"; routing: {flips} of {routed} (token, layer) top-{cfg.moe.top_k} sets differ"
           if cfg.moe else ""))
    if not torch.allclose(lk, lr, atol=2e-2, rtol=2e-2):
        raise AssertionError(f"{name}: float32 kernel prefill logits differ from the "
                             f"reference's beyond 2e-2")
    out = {"max_abs_diff": err, "route_flips": flips, "routed": routed}
    if decode_steps:
        if not torch.equal(streams["kernel"], streams["reference"]):
            diff = (streams["kernel"] != streams["reference"]).nonzero()
            raise AssertionError(f"{name}: {decode_steps} greedy steps from the kernel prefill "
                                 f"leave the reference's stream at {diff[:4].tolist()}")
        log(f"[{name}] {decode_steps} greedy decode steps from each prefill's cache: the same "
            f"{tuple(streams['kernel'].shape)} tokens")
        out["decode_steps"] = decode_steps
    del p, logits
    torch.cuda.empty_cache()
    return out


def _prefill_profile(name: str, cfg, params, prompts, kernels: tuple) -> dict:
    """One bf16 kernel prefill timed warm on the host clock, then one under
    torch.profiler: the device time of all its kernels and of the named
    scan kernels (their launches and ms) within it."""
    prefill(cfg, params, prompts, impl="kernel")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(cfg, params, prompts, impl="kernel")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prefill(cfg, params, prompts, impl="kernel")
        torch.cuda.synchronize()
    device_ms, scan = 0.0, {k: [0.0, 0] for k in kernels}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        device_ms += dev_us / 1e3
        for k in kernels:
            if k in e.key:
                scan[k][0] += dev_us / 1e3
                scan[k][1] += e.count
    out = {"prefill_ms": wall_ms,
           "device_ms": device_ms if device_ms else None,
           "kernels": {k: {"ms": v[0], "launches": v[1]} for k, v in scan.items()}
           if device_ms else None}
    if device_ms:
        log(f"[{name}] prefill {wall_ms:.1f} ms (warm, host clock); under the profiler its "
            f"kernels take {device_ms:.1f} ms of device time, of it "
            + ", ".join(f"{k} {v[0]:.2f} ms in {v[1]} launches" for k, v in scan.items()))
    else:
        log(f"[{name}] prefill {wall_ms:.1f} ms (warm, host clock); the profiler reported no "
            "device time (the kernels' share not measured)")
    torch.cuda.empty_cache()
    return out


def _serve_and_resume(name: str, arch: str, params, prompts) -> dict:
    """The uninterrupted run, the crashed run and the resume; every flush
    checked against the live bytes; the resumed stream against the
    uninterrupted one."""
    shutil.rmtree(SERVE_WORKDIR, ignore_errors=True)
    try:
        clean = serve.run(_serve_args(os.path.join(SERVE_WORKDIR, "clean"), arch=arch),
                          params=params, prompts=prompts, on_flush=_check_images)
        crash_dir = os.path.join(SERVE_WORKDIR, "crash")
        try:
            serve.run(_serve_args(crash_dir, SERVE_CRASH_AT, arch=arch), params=params,
                      prompts=prompts, on_flush=_check_images)
            raise AssertionError("the injected failure did not fire")
        except serve.SimulatedFailure as e:
            log(f"[{name}] {e}; restarting from the arena")
        resumed = serve.run(_serve_args(crash_dir, arch=arch), params=params, prompts=prompts,
                            on_flush=_check_images)
    finally:
        shutil.rmtree(SERVE_WORKDIR, ignore_errors=True)
    if not resumed["resumed"] or resumed["decode_steps"] != SERVE_STEPS - SERVE_CRASH_AT:
        raise AssertionError(f"{name}: the restart did not resume at step {SERVE_CRASH_AT}")
    if not np.array_equal(resumed["tokens"], clean["tokens"]):
        diff = np.argwhere(resumed["tokens"] != clean["tokens"])
        raise AssertionError(f"{name}: the resumed stream differs from the uninterrupted one "
                             f"at {diff[:4]}")
    return {"clean": clean, "resumed": resumed}


def _serve_summary(name: str, runs: dict, extra: dict) -> dict:
    clean, resumed = runs["clean"], runs["resumed"]
    n_flush = len(clean["flush_bytes"])
    split = {k: v / n_flush for k, v in clean["flush_split_ms"].items()}
    out = {
        "prefill_ms": clean["prefill_ms"],
        "decode_ms_per_step": clean["decode_ms_per_step"],
        "tokens_per_s": clean["tokens_per_s"],
        "flush_ms_mean": clean["flush_ms"] / n_flush,
        "flush_split_ms_mean": split,
        "flush_bytes": clean["flush_bytes"],
        "resumed_flush_bytes": resumed["flush_bytes"],
        **extra,
    }
    log(f"[{name}] prefill {out['prefill_ms']:.1f} ms, decode {out['decode_ms_per_step']:.2f} "
        f"ms/step, flush {out['flush_ms_mean']:.1f} ms mean of {n_flush} (mask "
        f"{split['mask_seconds']:.1f}, device-to-host {split['copy_seconds']:.1f}, arena "
        f"{split['arena_seconds']:.1f} ms); bytes per flush {clean['flush_bytes']}, after the "
        f"resume {resumed['flush_bytes']}")
    log(f"[{name}] resumed stream equals the uninterrupted one ({resumed['tokens'].shape}); "
        f"every flushed image equalled the live bytes; {json.dumps(extra)}")
    return out


def _n_tensor_leaves(cfg) -> int:
    """Tensor leaves the server flushes: t, the tokens, and the two cache
    leaves of each layer position (k, v; h, conv; S, x_last)."""
    return 2 + 2 * sum(len(pattern) for pattern, _ in cfg.groups)


def _check_delta_launches(name: str, cfg, launches: int) -> None:
    # one per tensor leaf and delta flush: 3 in the clean run, 1 before the
    # crash (the first flush writes everything) and 2 after the resume
    want = _n_tensor_leaves(cfg) * (3 + 1 + 2)
    if launches != want:
        raise AssertionError(f"{name}: delta_snapshot launched {launches} times, expected {want}")


def phase_serve_rwkv(dev: str) -> dict:
    cfg = get_arch(RWKV_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(int(x.numel()) for x in _leaves(params))
    log(f"[rwkv] {RWKV_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} "
        f"parameters in {cfg.dtype}, init {time.perf_counter() - t0:.1f} s")
    prompts = serve.make_prompts(cfg, SERVE_PROMPTS, SERVE_PROMPT_LEN, dev)
    _compare_prefills("rwkv", cfg, params, prompts)
    breakdown = _prefill_profile("rwkv", cfg, params, prompts, ("rwkv6_scan",))
    profile = _profile_decode(cfg, params, prompts, dev, name="rwkv")
    torch.cuda.empty_cache()

    rwkv6_scan.launches = 0
    dirty_block_mask.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = _serve_and_resume("rwkv", RWKV_ARCH, params, prompts)
    scan_launches, delta_launches = rwkv6_scan.launches, dirty_block_mask.launches
    peak = torch.cuda.max_memory_allocated()
    # 2 prefills (the uninterrupted run, the crashed run); the resume has none
    if scan_launches != 2 * cfg.n_layers:
        raise AssertionError(f"rwkv6_scan launched {scan_launches} times, "
                             f"expected {2 * cfg.n_layers} (once per layer and prefill)")
    _check_delta_launches("rwkv", cfg, delta_launches)
    H, dh = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    s_bytes = cfg.n_layers * SERVE_PROMPTS * H * dh * dh * 4
    later = runs["clean"]["flush_bytes"][1:] + runs["resumed"]["flush_bytes"]
    if not all(b >= s_bytes for b in later):
        raise AssertionError(f"rwkv: delta flushes wrote {later} bytes, fewer than the "
                             f"{s_bytes} of the state S that every token rewrites")
    del params
    torch.cuda.empty_cache()
    return _serve_summary("rwkv", runs, {
        "prefill_breakdown": breakdown, "decode_profile": profile, "state_S_bytes": s_bytes,
        "state_x_last_bytes": cfg.n_layers * SERVE_PROMPTS * cfg.d_model * 2,
        "peak_device_bytes": peak, "rwkv6_launches": scan_launches,
        "delta_launches": delta_launches})


def _rg_reduced(cfg, params):
    """RecurrentGemma cut to one (rec, rec, attn) repeat and the (rec, rec)
    tail: 5 layers at full width, the weights the first layers' own."""
    c = dataclasses.replace(cfg, n_layers=5, layer_groups=((("rec", "rec", "attn"), 1),
                                                            (("rec", "rec"), 1)))
    p = dict(params)
    p["group0"] = _tree_map(params["group0"], lambda x: x[:1])
    return c, p


def phase_serve_rg(dev: str) -> dict:
    cfg = get_arch(RG_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(int(x.numel()) for x in _leaves(params))
    log(f"[rg] {RG_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} "
        f"parameters in {cfg.dtype}, init {time.perf_counter() - t0:.1f} s")
    prompts = serve.make_prompts(cfg, SERVE_PROMPTS, SERVE_PROMPT_LEN, dev)
    _compare_prefills("rg", *_rg_reduced(cfg, params), prompts)
    breakdown = _prefill_profile("rg", cfg, params, prompts, ("rglru_scan", "flash_"))
    profile = _profile_decode(cfg, params, prompts, dev, name="rg")
    torch.cuda.empty_cache()

    n_rec = sum(pattern.count("rec") * rep for pattern, rep in cfg.groups)
    n_attn = sum(pattern.count("attn") * rep for pattern, rep in cfg.groups)
    rglru_scan.launches = 0
    flash_attention.launches = 0
    dirty_block_mask.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = _serve_and_resume("rg", RG_ARCH, params, prompts)
    scan_launches, flash_launches = rglru_scan.launches, flash_attention.launches
    delta_launches = dirty_block_mask.launches
    peak = torch.cuda.max_memory_allocated()
    # per prefill, each RG-LRU layer scans once: the decode cache's h is the
    # last step of that scan, not a second one (2 prefills, the resume has none)
    if scan_launches != 2 * n_rec:
        raise AssertionError(f"rglru_scan launched {scan_launches} times, expected "
                             f"{2 * n_rec} (once per RG-LRU layer and prefill)")
    if flash_launches != 2 * n_attn:
        raise AssertionError(f"flash_attention launched {flash_launches} times, expected "
                             f"{2 * n_attn} (once per attention layer and prefill)")
    _check_delta_launches("rg", cfg, delta_launches)
    del params
    torch.cuda.empty_cache()
    return _serve_summary("rg", runs, {
        "prefill_breakdown": breakdown, "decode_profile": profile,
        "state_h_bytes": n_rec * SERVE_PROMPTS * cfg.rec.d_rnn * 4,
        "state_conv_bytes": n_rec * SERVE_PROMPTS * (cfg.rec.conv_width - 1) * cfg.rec.d_rnn * 2,
        "kv_cache_bytes_per_leaf": n_attn * SERVE_PROMPTS * (SERVE_PROMPT_LEN + SERVE_STEPS + 1)
        * cfg.n_kv_heads * cfg.head_dim * 2,
        "peak_device_bytes": peak, "rglru_launches": scan_launches,
        "flash_launches": flash_launches, "delta_launches": delta_launches})


# ------------------------------- 11. the suite's apps and lm-train, characterized
def _golden_divergence(name: str, dev: str) -> str:
    """Information: the CI app's golden run on the card and on the CPU in
    step; the first iteration after which a state leaf differs in its bits,
    and the largest difference of a float leaf at the end."""
    apps = {d: ci_app(name, device=d) for d in ("cpu", dev)}
    states = {d: apps[d].init(0) for d in apps}
    first, n = None, 0
    while n < apps["cpu"].n_iters:
        states = {d: apps[d].run_iteration(states[d]) for d in apps}
        n += 1
        if first is None and any(states["cpu"][k].tobytes() != states[dev][k].tobytes()
                                 for k in states["cpu"]):
            first = n
        if apps["cpu"].converged(states["cpu"], n):
            break
    diff = max((float(np.abs(states["cpu"][k] - states[dev][k]).max())
                for k in states["cpu"] if states["cpu"][k].dtype.kind == "f"), default=0.0)
    return (f"the card's golden run is the CPU's bit for bit through {n} iterations"
            if first is None else
            f"the card's golden run leaves the CPU's bits after iteration {first} of {n}; "
            f"max |diff| at the end {diff:.3e}")


def phase_characterize_suite(dev: str) -> dict:
    """heat, cg, pagerank, kmeans: the pin and the JAX plan on the card."""
    plans = {}
    for name, want in JAX_HPC_PLANS.items():
        app = ci_app(name, device=dev)
        _check_pin(name, app, tag="suite")
        plan = _workflow_plan(name, app, tag="suite")
        if (plan.objects, plan.region_freq) != want:
            raise AssertionError(f"{name}: plan differs from the JAX plan {want}")
        log(f"[suite] {name}: {_golden_divergence(name, dev)}")
        plans[name] = plan
    return plans


def phase_characterize_lm_train(dev: str) -> PersistPlan:
    """lm-train with the port's generator weights on the CPU and on the card:
    the same class counts, golden_iters, crash_iters and plan."""
    got = {}
    for d in ("cpu", dev):
        app = ci_app("lm-train", device=d)
        t0 = time.perf_counter()
        entry = _campaign_entry(app)
        log(f"[lm-train] campaign on {d}: {entry} in {time.perf_counter() - t0:.1f} s")
        plan = _workflow_plan("lm-train", app, tag="lm-train")
        got[d] = (entry, (plan.objects, plan.region_freq))
    if got["cpu"] != got[dev]:
        raise AssertionError(f"lm-train on the card {got[dev]} differs from the CPU's "
                             f"{got['cpu']}")
    log(f"[lm-train] {_golden_divergence('lm-train', dev)}")
    return plan


# ------------------------------------------------ 12. the suite's deployments
def phase_deploy_suite(dev: str, plans: dict) -> dict:
    """Each app of DEPLOY_APPS at its size, with the launches of
    ``delta_snapshot`` counted per deployment: one per object and delta
    flush."""
    out = {}
    for name, size in DEPLOY_APPS:
        app = get_app(name, device=dev, **size)
        plan = plans[name]
        if plan.region_freq:
            label = "run_workflow's plan"
        else:
            plan = PersistPlan.at_loop_end(plan.objects, app)
            label = ("loop-end baseline (paper Fig 2a): run_workflow's plan flushes nothing, "
                     "so the selected objects at the end of every iteration")
        dirty_block_mask.launches = 0
        res = deploy(dev, name, app, plan, label)
        launches = dirty_block_mask.launches
        want = delta_launches_expected(plan)
        if launches != want:
            raise AssertionError(f"{name}: delta_snapshot launched {launches} times, expected "
                                 f"one per object and delta flush ({want})")
        res["delta_launches"] = launches
        res["size"] = size
        log(f"[deploy {name}] summary {json.dumps(res)}")
        out[name] = res
        del app
        torch.cuda.empty_cache()
    return out


# ------------------------------- 13. mg and montecarlo, and the lane driver
def _torn_write_entry(name: str, app) -> dict:
    with open(GOLDENS) as f:
        cfg = json.load(f)["config"]
    fault = get_fault_model("torn-write", app=app)
    camp = CrashTester(app, PersistPlan.none(), default_cache(app), seed=cfg["seed"],
                       fault=fault).run_campaign(cfg["n_tests"])
    counts = {c: 0 for c in ("S1", "S2", "S3", "S4")}
    for r in camp.records:
        counts[r.outcome] += 1
    return {"counts": counts, "golden_iters": camp.golden_iters,
            "crash_iters": [r.iter_idx for r in camp.records]}


def _serial_phase_a(app, s0, it: int, stop: int):
    """The campaign's phase-A loop for one lane: step, then converged(), to
    the budget; (state, it, ok), ok False where converged() raised."""
    s = dict(s0)
    while it < stop:
        s = app.run_iteration(s)
        it += 1
        try:
            if app.converged(s, it):
                break
        except FloatingPointError:
            return s, it, False
    return s, it, True


def _host_phase_a(app, states, its, stop: int) -> None:
    """The crash tester's phase A without a driver: per iteration, one
    run_iteration_batch and one converged_batch over the running lanes,
    padded to a power of two as ``CrashTester._call_padded`` pads them."""
    lanes = [[s, int(it)] for s, it in zip(states, its) if it < stop]
    while lanes:
        for l, s in zip(lanes, CrashTester._call_padded(app.run_iteration_batch,
                                                        [l[0] for l in lanes])):
            l[0], l[1] = s, l[1] + 1
        convs = CrashTester._call_padded(app.converged_batch, [l[0] for l in lanes],
                                         [l[1] for l in lanes])
        lanes = [l for l, c in zip(lanes, convs)
                 if not (isinstance(c, BaseException) or c or l[1] >= stop)]


def _syncs_and_ms(fn) -> tuple:
    """(host syncs, ms) of ``fn()``: the syncs counted by torch's sync debug
    mode in one run, the time of a second run without it."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if any("advance_lanes raised" in str(w.message) for w in caught):
        raise AssertionError("a lane driver fell back to the host loop")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return syncs, (time.perf_counter() - t0) * 1e3


def _check_driver_bitwise(name: str, app) -> None:
    """advance_lanes on the card (a CUDA graph, but for montecarlo's
    bespoke replay) against the serial host loop on the card, state for
    state bitwise, for perturbed lanes entering at scattered iterations."""
    s = app.init(0)
    traj, stop, it = [s], app.n_iters, 0
    while it < app.n_iters:
        s = app.run_iteration(s)
        it += 1
        traj.append(s)
        if app.converged(s, it):
            stop = it
            break
    rng = np.random.default_rng(7)
    field = DRIVER_NOISE_FIELD[name]
    entry = sorted({1, stop // 4, stop // 2, max(stop - 1, 1), stop})
    lanes = []
    for ei in entry:
        lane = {k: np.array(v, copy=True) for k, v in traj[ei].items()}
        lane[field] = (lane[field] + rng.standard_normal(lane[field].shape) * 1e-5
                       ).astype(lane[field].dtype)
        lanes.append(lane)
    captures, replays = lane_driver.STATS.captures, lane_driver.STATS.replays
    states, its, oks = app.advance_lanes(lanes, entry, stop)
    for i, (lane, ei) in enumerate(zip(lanes, entry)):
        want, wit, wok = _serial_phase_a(app, lane, ei, stop)
        if not (wok and oks[i] and its[i] == wit):
            raise AssertionError(f"{name} lane {i}: driver (ok={oks[i]}, it={its[i]}) against "
                                 f"the serial loop (ok={wok}, it={wit})")
        for k in want:
            if np.asarray(want[k]).tobytes() != np.asarray(states[i][k]).tobytes():
                raise AssertionError(f"{name} lane {i}: {k!r} differs from the serial loop's")
    replays = lane_driver.STATS.replays - replays
    if name != "montecarlo" and replays < 1:
        raise AssertionError(f"{name}: advance_lanes replayed no CUDA graph")
    log(f"[slice7] {name}: advance_lanes on the card equals the serial loop bitwise for "
        f"lanes entering at {entry} (stop {stop}); {lane_driver.STATS.captures - captures} "
        f"graph(s) captured, {replays} replays")


def _time_phase_a(name: str, app) -> dict:
    """The pinned campaign with the driver, recording each advance_lanes
    call (its first run captures the buckets' graphs); then, warm, phase A
    of those calls both ways, the driver and the host loop (ms and host
    syncs summed over the campaign), and the whole campaign both ways."""
    calls = []
    advance = app.advance_lanes

    def recorded(states, its, stop):
        calls.append(([dict(s) for s in states], list(its), int(stop)))
        return advance(states, its, stop)

    app.advance_lanes = recorded
    t0 = time.perf_counter()
    _campaign_entry(app)
    first_ms = (time.perf_counter() - t0) * 1e3
    app.advance_lanes = advance
    out = {"lanes": sum(len(c[0]) for c in calls), "calls": len(calls)}
    before = dataclasses.replace(lane_driver.STATS)
    for route, fn in (("driver", lambda: [advance(*c) for c in calls]),
                      ("host_loop", lambda: [_host_phase_a(app, *c) for c in calls])):
        syncs, ms = _syncs_and_ms(fn)
        out[f"{route}_ms"], out[f"{route}_syncs"] = ms, syncs
    # the driver ran twice above (counted, then timed)
    out["driver_chunks"] = (lane_driver.STATS.chunks - before.chunks) // 2
    for route, on in (("campaign_ms", True), ("campaign_ms_host_loop", False)):
        app.supports_lane_driver = on
        t0 = time.perf_counter()
        _campaign_entry(app)
        out[route] = (time.perf_counter() - t0) * 1e3
    del app.supports_lane_driver
    out["campaign_ms_first"] = first_ms
    log(f"[slice7] {name} phase A over the pinned campaign ({out['calls']} calls, "
        f"{out['lanes']} lanes): driver {out['driver_ms']:.1f} ms, {out['driver_syncs']} host "
        f"syncs, {out['driver_chunks']} chunks; host loop {out['host_loop_ms']:.1f} ms, "
        f"{out['host_loop_syncs']} host syncs; whole campaign {out['campaign_ms']:.0f} ms "
        f"with the driver (the first, capturing, {first_ms:.0f} ms), "
        f"{out['campaign_ms_host_loop']:.0f} ms without")
    return out


def phase_slice7(dev: str) -> dict:
    """mg and montecarlo: pins (mg's torn-write pin too), the JAX plans,
    the card's golden run against the CPU's; then the lane driver of all six
    apps on the card, bitwise against the serial loop, and phase A timed."""
    plans = {}
    for name, want in JAX_SLICE7_PLANS.items():
        app = ci_app(name, device=dev)
        _check_pin(name, app, tag="slice7")
        if name == "mg":
            with open(GOLDENS) as f:
                pin = json.load(f)["torn_write_apps"]["mg"]
            got = _torn_write_entry(name, app)
            log(f"[slice7] mg torn-write campaign on {dev}: {got}")
            if got != pin:
                raise AssertionError(f"mg torn-write campaign differs from its golden {pin}")
        plan = _workflow_plan(name, app, tag="slice7")
        if (plan.objects, plan.region_freq) != want:
            raise AssertionError(f"{name}: plan differs from the JAX plan {want}")
        log(f"[slice7] {name}: {_golden_divergence(name, dev)}")
        plans[name] = plan
    timing = {}
    for name in DRIVER_NOISE_FIELD:
        app = ci_app(name, device=dev)
        _check_driver_bitwise(name, app)
        timing[name] = _time_phase_a(name, app)
    log(f"[slice7] lane driver totals {dataclasses.asdict(lane_driver.STATS)}")
    return {"plans": plans, "phase_a": timing}


# ------------------------------------------- 14. mg and montecarlo deployed
def phase_deploy_slice7(dev: str, plans: dict) -> dict:
    """mg at grid 8192 and montecarlo at 2**26 pairs per iteration, each
    flushing after the regions its plan names, with the launches of
    ``delta_snapshot`` counted per deployment."""
    out = {}
    for name, size in DEPLOY_SLICE7:
        app = get_app(name, device=dev, **size)
        plan = plans[name]
        points = tuple(sorted(plan.region_freq))
        if any(plan.region_freq[i] != 1 for i in points):
            raise AssertionError(f"{name}: the deployment flushes every iteration, the plan "
                                 f"says {plan.region_freq}")
        extra = None
        if name == "montecarlo":
            pairs = float(app.batch)
            extra = ("pairs_counted", app.progress,
                     lambda v: v == [pairs * (DEPLOY_ITERS + k) for k in range(len(v))])
        dirty_block_mask.launches = 0
        res = deploy(dev, name, app, plan, "run_workflow's plan", extra=extra,
                     flush_after=points)
        launches = dirty_block_mask.launches
        want = delta_launches_expected(plan, len(points))
        if launches != want:
            raise AssertionError(f"{name}: delta_snapshot launched {launches} times, expected "
                                 f"one per object and delta flush ({want})")
        res["delta_launches"] = launches
        res["size"] = size
        log(f"[deploy {name}] summary {json.dumps(res)}")
        out[name] = res
        del app
        torch.cuda.empty_cache()
    return out


# -------------------------------------------- 15. the trainer under failures
def _train_args(workdir: str, *extra: str) -> argparse.Namespace:
    return train.parser().parse_args([
        "--arch", TRAIN_ARCH, "--full-size", "--persist-mode", "delta",
        "--workdir", workdir, "--log-every", "1000000", *extra,
    ])


def _host_equals(host: np.ndarray, live: torch.Tensor, stream=None) -> bool:
    """Whether a host array holds a tensor's bytes (compared on its device)."""
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        img = torch.from_numpy(np.ascontiguousarray(host).reshape(-1).view(np.uint8))
        img = img.to(live.device)
        return bool(img.numel() == live.numel() * live.element_size()
                    and torch.equal(img, live.reshape(-1).view(torch.uint8)))


class _FlushCheck:
    """on_flushed hook: every arena image equals the bytes its flush cloned.
    Runs on the manager's writer thread, on a stream of its own (the clone
    is complete: the flush already copied it to the host)."""

    def __init__(self):
        self.stream = torch.cuda.Stream()
        self.steps = []

    def __call__(self, step: int, payload: dict, arena: NVMArena) -> None:
        for name, leaf in payload.items():
            img = arena.peek(name)
            same = (img is not None and (
                _host_equals(img, leaf, self.stream) if isinstance(leaf, torch.Tensor)
                else img.tobytes() == np.asarray(leaf).tobytes()))
            if not same:
                raise AssertionError(f"flush at step {step}: arena image of {name!r} "
                                     "differs from the flushed clone")
        self.steps.append(step)


def _check_state_equals(label: str, state: dict, flat_host: dict) -> None:
    flat = flatten_state(state)
    if set(flat) != set(flat_host):
        raise AssertionError(f"{label}: leaves {sorted(set(flat) ^ set(flat_host))} differ")
    for name, live in flat.items():
        if not _host_equals(flat_host[name], live):
            raise AssertionError(f"{label}: {name!r} differs from the stored bytes")


def _train_run(label: str, args, cfg, check: _FlushCheck, expect: tuple) -> dict:
    """One train.run with its restore checked against the bytes it came from
    (``expect``: source and step) and delta_snapshot's launches counted."""
    arena_dir = os.path.join(args.workdir, "arena")
    restored = {}

    def on_restore(state, step, source):
        restored.update(source=source, step=step)
        if source == "easycrash":
            arena = NVMArena.reattach(arena_dir)
            if int(arena.get("__step__")) != step:
                raise AssertionError(f"{label}: restored step {step} != the arena's")
            _check_state_equals(f"{label} (arena)", state["params"],
                                {k[len("params/"):]: arena.get(k) for k in arena.names()
                                 if k.startswith("params/")})
        elif source == "checkpoint":
            for tier in ("ckpt_local", "ckpt_remote"):
                d = os.path.join(args.workdir, tier, f"step_{step:010d}")
                if os.path.exists(os.path.join(d, "manifest.json")):
                    restored["tier"] = tier
                    _check_state_equals(f"{label} ({tier})", state,
                                        flatten_tree(load_pytree(d)))
                    break
            else:
                raise AssertionError(f"{label}: no checkpoint of step {step} on disk")

    fresh = not os.path.exists(os.path.join(arena_dir, "manifest.json"))
    dirty_block_mask.launches = 0
    st = train.run(args, cfg, on_flushed=check, on_restore=on_restore)
    st["delta_launches"] = dirty_block_mask.launches
    if (restored["source"], restored["step"]) != expect:
        raise AssertionError(f"{label}: restored from {restored['source']} at step "
                             f"{restored['step']}, expected {expect}")
    st["tier"] = restored.get("tier")
    st["fresh_arena"] = fresh
    return st


def _check_delta_count(label: str, launches: int, leaves: int, flushes: int,
                       fresh: bool) -> None:
    """One launch per tensor leaf (the parameter leaves and step) and delta
    flush; the first flush into a fresh arena compares nothing."""
    want = leaves * (flushes - (1 if fresh and flushes else 0))
    if launches != want:
        raise AssertionError(f"{label}: delta_snapshot launched {launches} times, expected "
                             f"{want} ({leaves} tensor leaves, {flushes} flushes)")


def _profile_train_steps(cfg, dev: str, steps: int = 2) -> dict:
    """Two warm train steps (no flush) under the profiler: wall and device
    time, idle share, and the matrix products' share of the device time."""
    args = _train_args(os.path.join(TRAIN_WORKDIR, "profile"), "--steps", str(TRAIN_STEPS))
    _, data_cfg, step_fn = train.build(args, cfg)
    stream = SyntheticLMStream(data_cfg)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(stream)[1].items()}
               for _ in range(steps + 1)]
    stream.close()
    box = {"state": train.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0)),
           "i": 0}

    def one():
        box["state"], m = step_fn(box["state"], batches[box["i"]])
        box["i"] += 1
        float(m["loss"])  # the trainer's per-step wait

    one()  # warm-up
    out = _kernel_profile(one, steps)
    del box
    torch.cuda.empty_cache()
    if out["device_ms"]:
        log(f"[train] profile of {steps} steps: wall {out['wall_ms']:.1f} ms, device "
            f"{out['device_ms']:.1f} ms, idle share {out['idle_share']:.1%}, matrix products "
            f"{out['gemm_share']:.1%} of device time; top kernels (ms, launches): {out['top']}")
    else:
        log("[train] profile: the profiler reported no device time (idle share not measured)")
    return out


def phase_train(dev: str) -> dict:
    """Phase 15, and phase 19 (c) on its newest checkpoint before its work
    directory is deleted (under ``"reshard"``)."""
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    shutil.rmtree(TRAIN_WORKDIR, ignore_errors=True)
    check = _FlushCheck()
    shape = {}

    def count(state, step, source):
        shape["parameters"] = sum(int(x.numel()) for x in _leaves(state["params"]))
        shape["leaves"] = 1 + sum(1 for _ in _leaves(state["params"]))  # and step

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    try:
        # a warm-up (allocator, cuBLAS), then (a): no flush, no checkpoint
        none = ("--flush-every", "1000000000", "--mtbf", "1e12")
        train.run(_train_args(os.path.join(TRAIN_WORKDIR, "warm"), "--steps", "2", *none), cfg)
        base = train.run(_train_args(os.path.join(TRAIN_WORKDIR, "base"),
                                     "--steps", str(TRAIN_STEPS), *none), cfg, on_restore=count)
        leaves = shape["leaves"]
        log(f"[train] {TRAIN_ARCH} at {TRAIN_LAYERS} of {get_arch(TRAIN_ARCH).n_layers} layers, "
            f"{shape['parameters']} parameters, {leaves} tensor leaves flushed")
        profile = _profile_train_steps(cfg, dev)

        # (b) async delta flushes every 4, checkpoints every 8, a crash at 12
        wd = os.path.join(TRAIN_WORKDIR, "run")
        arena_dir = os.path.join(wd, "arena")
        flags = ("--flush-every", str(TRAIN_FLUSH_EVERY), *TRAIN_CKPT_FLAGS)
        crash_args = _train_args(wd, "--steps", str(TRAIN_STEPS), *flags,
                                 "--inject-failure-every", str(TRAIN_CRASH_AT))
        dirty_block_mask.launches = 0
        try:
            train.run(crash_args, cfg, on_flushed=check)
            raise AssertionError("the injected failure did not fire")
        except train.SimulatedFailure as e:
            log(f"[train] {e}; restarting")
        _check_delta_count("(b) before the crash", dirty_block_mask.launches, leaves, 3, True)
        if check.steps != [4, 8, 12]:
            raise AssertionError(f"flushes landed at {check.steps}, not at 4, 8 and 12")
        first_launches = dirty_block_mask.launches
        run_b = _train_run("(b)", crash_args, cfg, check, ("easycrash", TRAIN_CRASH_AT))
        if run_b["final_step"] != TRAIN_STEPS or run_b["checkpoint_every"] != TRAIN_CKPT_EVERY:
            raise AssertionError(f"(b) ended at {run_b['final_step']} with checkpoints every "
                                 f"{run_b['checkpoint_every']} steps")
        log(f"[train] (b) restored from the arena at step {run_b['restore_step']}, the last "
            f"flush issued before the crash; parameters equal to its image")

        # (c) the arena lost; (d) the local tier too; (e) verify rejects the arena
        shutil.rmtree(arena_dir)
        more = ("--steps", str(TRAIN_MORE_STEPS), *flags)
        run_c = _train_run("(c)", _train_args(wd, *more), cfg, check, ("checkpoint", TRAIN_STEPS))
        shutil.rmtree(arena_dir)
        shutil.rmtree(os.path.join(wd, "ckpt_local"))
        run_d = _train_run("(d)", _train_args(wd, *more), cfg, check, ("checkpoint", TRAIN_STEPS))
        if run_c["tier"] != "ckpt_local" or run_d["tier"] != "ckpt_remote":
            raise AssertionError(f"(c) restored from {run_c['tier']}, (d) from {run_d['tier']}")
        if not os.path.exists(os.path.join(arena_dir, "manifest.json")):
            raise AssertionError("(d) left no arena for (e)")
        run_e = _train_run("(e)", _train_args(wd, "--steps", str(TRAIN_STEPS), *flags,
                                              "--verify-loss-max", "0"),
                           cfg, check, ("checkpoint", TRAIN_STEPS))
        log(f"[train] (c) restored from the local tier, (d) from the remote tier, (e) from "
            f"the {run_e['tier']} after rejecting the arena; each equal to the stored bytes; "
            f"every arena image equalled its flush's clone ({len(check.steps)} flushes)")
        peak = torch.cuda.max_memory_allocated()
        resharded = phase_reshard(cfg, dev, wd)
    finally:
        shutil.rmtree(TRAIN_WORKDIR, ignore_errors=True)

    for label, st in (("(b)", run_b), ("(c)", run_c), ("(d)", run_d), ("(e)", run_e)):
        _check_delta_count(label, st["delta_launches"], leaves, st["flushes"], st["fresh_arena"])
    delta_launches = first_launches + sum(r["delta_launches"] for r in (run_b, run_c, run_d, run_e))
    if delta_launches != leaves * 5:  # 8 and 12 before the crash; 16, 20, 24 after
        raise AssertionError(f"delta_snapshot launched {delta_launches} times, not {leaves * 5}")

    # the persistence tax: (b)'s steps (both halves, crash excluded) against (a)'s
    ms_b = run_b["ms_per_step"]
    tax = ms_b / base["ms_per_step"]
    n_delta = run_b["flushes"]
    split = {k: v / max(n_delta, 1) for k, v in run_b["flush_split_ms"].items()}
    saves = run_b["checkpoint_save_s"]
    t_chk = float(np.mean(saves))
    t_s = max(0.0, 1.0 - base["ms_per_step"] / ms_b)
    sysc = system_config_from_measurement(t_chk, run_b["checkpoint_bytes"], mtbf=TRAIN_EFF_MTBF)
    out = {
        "arch": TRAIN_ARCH, "layers": TRAIN_LAYERS, "parameters": shape["parameters"],
        "ms_per_step_baseline": base["ms_per_step"],
        "step_ms_baseline": base["step_ms"],
        "ms_per_step_persist": ms_b,
        "ms_per_step_persist_steps_only": run_b["ms_per_step_without_flush_calls"],
        "step_ms_persist": run_b["step_ms"],
        "persistence_tax": tax,
        "flushes": n_delta, "flushes_skipped": run_b["flushes_skipped"],
        "flush_call_ms": run_b["flush_call_ms"] / max(n_delta, 1),
        "flush_split_ms_per_flush": split,
        "bytes_per_delta_flush": run_b["bytes_written"] / max(n_delta, 1),
        "delta_launches": delta_launches, "tensor_leaves": leaves,
        "checkpoint_save_s": saves, "checkpoint_bytes": run_b["checkpoint_bytes"],
        "checkpoint_call_ms": run_b["checkpoint_call_ms"],
        "t_chk_s": t_chk, "t_s": t_s,
        "efficiency_without": efficiency_without(sysc).efficiency,
        "efficiency_with": efficiency_with(sysc, TRAIN_EFF_R, t_s=t_s).efficiency,
        "restore_ms": {"easycrash": run_b["restore_ms"], "checkpoint_local": run_c["restore_ms"],
                       "checkpoint_remote": run_d["restore_ms"],
                       "checkpoint_after_reject": run_e["restore_ms"]},
        "final_loss": run_b["final_loss"],
        "step_profile": profile,
        "peak_device_bytes": peak,
        "seconds": time.perf_counter() - t_start,
        "reshard": resharded,
    }
    log(f"[train] {out['ms_per_step_baseline']:.2f} ms/step without persistence, "
        f"{ms_b:.2f} with async delta flushes every {TRAIN_FLUSH_EVERY} "
        f"(tax {tax:.3f}x; steps alone {out['ms_per_step_persist_steps_only']:.2f})")
    log(f"[train] flushes issued {n_delta}, skipped {out['flushes_skipped']}; per flush "
        f"mask {split['mask_seconds']:.1f}, device-to-host {split['copy_seconds']:.1f}, "
        f"arena {split['arena_seconds']:.1f} ms; {out['bytes_per_delta_flush']:.0f} bytes "
        f"per flush; delta_snapshot launches {delta_launches} = {leaves} leaves x 5 delta flushes")
    log(f"[train] checkpoints: {len(saves)} saves of {out['checkpoint_bytes']} bytes, "
        f"{', '.join(f'{x:.2f}' for x in saves)} s; T_chk {t_chk:.2f} s, t_s {t_s:.4f}; at "
        f"MTBF {TRAIN_EFF_MTBF:.0f} s efficiency without EasyCrash "
        f"{out['efficiency_without']:.4f}, with {out['efficiency_with']:.4f}")
    log(f"[train] restore ms: {json.dumps(out['restore_ms'])}; peak device memory {peak} "
        f"bytes; phase {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------- 16. serve --fleet
def phase_fleet(served: dict) -> dict:
    """fleet_report on phase 7's uninterrupted StableLM-2-1.6B run, at the
    launcher's fleet defaults."""
    t0 = time.perf_counter()
    args = _serve_args(os.path.join(SERVE_WORKDIR, "fleet"))
    doc = serve.fleet_report(served["fleet_stats"], args)
    if set(doc) != set(POLICIES):
        raise AssertionError(f"fleet policies {sorted(doc)} != {sorted(POLICIES)}")
    for policy, p in doc.items():
        if p["arrived"] != p["served"] + p["dropped"] + p["in_flight"]:
            raise AssertionError(f"fleet {policy}: requests not conserved: {p['arrived']} != "
                                 f"{p['served']} + {p['dropped']} + {p['in_flight']}")
    out = {policy: {k: p[k] for k in ("goodput", "dropped", "arrived", "slo_violation_frac",
                                      "latency_p99", "n_failures")}
           for policy, p in doc.items()}
    log(f"[fleet] {args.fleet_replicas} replicas, MTBF {args.fleet_mtbf:.0f} s, horizon "
        f"{args.fleet_horizon:.0f} s; requests conserved for every policy; "
        f"{time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------- 17. serving the MoE archs
#: the MoE layer's functions whose device time the prefill profile reads,
#: each inside a record_function range: the router, the dispatch into the
#: capacity buffers, the expert products, the combine, the shared MLP
MOE_PARTS = ("_route", "_dispatch", "_expert_mlp", "_combine", "mlp_apply")


def _annotated(label: str):
    def wrap(fn):
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return ranged
    return wrap


def _moe_prefill_profile(name: str, cfg, params, prompts) -> dict:
    """One bf16 kernel prefill timed warm on the host clock, then one under
    torch.profiler: the device time of all its kernels, of flash_attention's,
    and of the kernels each MoE function launches (the device time of its
    record_function range)."""
    prefill(cfg, params, prompts, impl="kernel")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(cfg, params, prompts, impl="kernel")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with contextlib.ExitStack() as stack:
        for part in MOE_PARTS:
            stack.enter_context(_patched(moe, part, _annotated(f"moe.{part}")))
        with torch.profiler.profile(activities=acts) as prof:
            prefill(cfg, params, prompts, impl="kernel")
            torch.cuda.synchronize()
    device_ms = flash_ms = 0.0
    parts = {}
    for e in prof.key_averages():
        if e.key.startswith("moe."):
            # the range on the host sums the kernels its ops launched; its
            # twin on the device (a user annotation) spans first kernel to
            # last, gaps included, and is not read
            if e.device_type == torch.autograd.DeviceType.CPU:
                total = getattr(e, "device_time_total", None)
                if total is None:
                    total = getattr(e, "cuda_time_total", 0)
                parts[e.key[4:]] = total / 1e3
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        device_ms += dev_us / 1e3
        if "flash_" in e.key:
            flash_ms += dev_us / 1e3
    if not device_ms:
        log(f"[{name}] prefill {wall_ms:.1f} ms (warm, host clock); the profiler reported no "
            "device time (the breakdown not measured)")
        return {"prefill_ms": wall_ms, "device_ms": None, "parts_ms": None}
    parts = {"flash_attention": flash_ms, **{k: parts.get(k, 0.0) for k in MOE_PARTS}}
    parts["other"] = device_ms - sum(parts.values())
    log(f"[{name}] prefill {wall_ms:.1f} ms (warm, host clock); under the profiler its kernels "
        f"take {device_ms:.1f} ms of device time: "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + " ms (mlp_apply: the shared "
        "MLP; other: projections, norms, embedding, logits)")
    torch.cuda.empty_cache()
    return {"prefill_ms": wall_ms, "device_ms": device_ms, "parts_ms": parts}


def _depth_cut(cfg, params, n: int):
    """An all-attention config cut to its first ``n`` layers, with those
    layers' own weights (views)."""
    c = dataclasses.replace(cfg, n_layers=n)
    p = dict(params)
    p["group0"] = _tree_map(params["group0"], lambda x: x[:n])
    return c, p


def phase_serve_moe(dev: str) -> dict:
    """(a) Qwen1.5-MoE-A2.7B at full width and depth, served as phase 7
    serves StableLM-2-1.6B, its prefills compared at 2 layers."""
    cfg = get_arch(MOE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(int(x.numel()) for x in _leaves(params))
    if n_params != MOE_PARAMS:
        raise AssertionError(f"{MOE_ARCH} has {n_params} parameters, not {MOE_PARAMS}")
    log(f"[qwen] {MOE_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, {n_params} parameters in "
        f"{cfg.dtype} (router f32), init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated()} bytes on the card")
    prompts = serve.make_prompts(cfg, SERVE_PROMPTS, SERVE_PROMPT_LEN, dev)
    compare = _compare_prefills("qwen", *_depth_cut(cfg, params, MOE_COMPARE_LAYERS), prompts)
    breakdown = _moe_prefill_profile("qwen", cfg, params, prompts)
    profile = _profile_decode(cfg, params, prompts, dev, name="qwen")
    torch.cuda.empty_cache()

    flash_attention.launches = 0
    dirty_block_mask.launches = 0
    torch.cuda.reset_peak_memory_stats()
    dropped = []
    with _patched(moe, "_dispatch", _recording(dropped, lambda out: (~out[2]).sum())):
        runs = _serve_and_resume("qwen", MOE_ARCH, params, prompts)
    flash_launches, delta_launches = flash_attention.launches, dirty_block_mask.launches
    peak = torch.cuda.max_memory_allocated()
    # 2 prefills (the uninterrupted run, the crashed run); the resume has none
    if flash_launches != 2 * cfg.n_layers:
        raise AssertionError(f"qwen: flash_attention launched {flash_launches} times, "
                             f"expected {2 * cfg.n_layers} (once per layer and prefill)")
    _check_delta_launches("qwen", cfg, delta_launches)
    _check_kv_flush_bytes("qwen", cfg, runs["clean"]["flush_bytes"][1:]
                          + runs["resumed"]["flush_bytes"])
    if len(dropped) != 2 * cfg.n_layers:
        raise AssertionError(f"qwen: {len(dropped)} sort dispatches, expected "
                             f"{2 * cfg.n_layers} (the prefills' layers)")
    slots = SERVE_PROMPTS * SERVE_PROMPT_LEN * cfg.moe.top_k * cfg.n_layers
    per_prefill = [int(sum(int(x) for x in dropped[i * cfg.n_layers:(i + 1) * cfg.n_layers]))
                   for i in range(2)]
    log(f"[qwen] slots dropped at capacity per prefill: {per_prefill} of {slots} "
        f"({per_prefill[0] / slots:.2%})")
    del params
    torch.cuda.empty_cache()
    row = cfg.n_kv_heads * cfg.head_dim * 2
    return _serve_summary("qwen", runs, {
        "n_params": n_params, "prefill_compare": compare, "prefill_breakdown": breakdown,
        "decode_profile": profile, "dropped_slots": per_prefill, "slots": slots,
        "kv_cache_bytes_per_leaf": cfg.n_layers * SERVE_PROMPTS
        * (SERVE_PROMPT_LEN + SERVE_STEPS + 1) * row,
        "peak_device_bytes": peak, "flash_launches": flash_launches,
        "delta_launches": delta_launches})


def phase_scout(dev: str) -> dict:
    """(b) Llama-4-Scout-17B-16E at full width, its depth cut to 2 layers:
    the kernel prefill against the reference prefill in float32 weights,
    then 8 greedy steps from each; the model's own bf16 kernel prefill
    timed."""
    cfg = dataclasses.replace(get_arch(SCOUT_ARCH), n_layers=SCOUT_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(int(x.numel()) for x in _leaves(params))
    log(f"[scout] {SCOUT_ARCH} cut to {cfg.n_layers} of 48 layers: d_model {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, {n_params} parameters in "
        f"{cfg.dtype}, init {time.perf_counter() - t0:.1f} s")
    prompts = serve.make_prompts(cfg, SERVE_PROMPTS, SERVE_PROMPT_LEN, dev)
    compare = _compare_prefills("scout", cfg, params, prompts, decode_steps=SCOUT_DECODE_STEPS)
    prefill(cfg, params, prompts, impl="kernel")  # warm-up
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(cfg, params, prompts, impl="kernel")
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"scout: flash_attention launched {launches} times in a prefill, "
                             f"expected {cfg.n_layers}")
    log(f"[scout] bf16 kernel prefill {prefill_ms:.1f} ms (warm, host clock), "
        f"flash_attention {launches} launches")
    del params
    torch.cuda.empty_cache()
    return {"n_params": n_params, "prefill_compare": compare, "prefill_ms": prefill_ms,
            "flash_launches": launches}


def _tree_map(tree, fn):
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ------------------------------------------------------------------ 18. static
def _check_static_equal(name: str, sp, ref) -> None:
    """The card's StaticPlan against the CPU's: the same traced flags,
    classes, decisions, write_bytes and uncertain regions; confidence and
    damping within 1e-4."""
    pairs = [(f"region {r.name}", (r.traced, r.decision, r.write_bytes),
              (c.traced, c.decision, c.write_bytes), r.confidence, c.confidence)
             for r, c in zip(sp.regions, ref.regions)]
    pairs += [(f"object {o.name}", (o.klass, o.decision), (c.klass, c.decision),
               o.confidence, c.confidence) for o, c in zip(sp.objects, ref.objects)]
    for what, got, want, conf, conf_ref in pairs:
        if got != want or abs(conf - conf_ref) > 1e-4:
            raise AssertionError(f"{name} {what}: card {got} {conf}, CPU {want} {conf_ref}")
    for o, c in zip(sp.objects, ref.objects):
        if (o.damping is None) != (c.damping is None) or (
                o.damping is not None and abs(o.damping - c.damping) > 1e-4):
            raise AssertionError(f"{name} {o.name}: damping {o.damping} on the card, "
                                 f"{c.damping} on the CPU")
    if (len(sp.regions), len(sp.objects), sp.uncertain_regions()) != \
            (len(ref.regions), len(ref.objects), ref.uncertain_regions()):
        raise AssertionError(f"{name}: the card's plan has other regions or objects")


def phase_static(dev: str) -> dict:
    """Phase 18: the static analyzer and its plan sources on the card, the
    lint over the kernels built there, and sor's static plan deployed."""
    with open(STATIC_AGREEMENT) as f:
        golden = json.load(f)
    out: dict = {"analyze_ms": {}, "workflow_ms": {}}
    agree = set()
    for name in STATIC_SUITE:
        app = ci_app(name, device=dev)
        t0 = time.perf_counter()
        sp = analyze_app(app, cache=default_cache(app))
        torch.cuda.synchronize()
        out["analyze_ms"][name] = (time.perf_counter() - t0) * 1e3
        cpu_app = ci_app(name, device="cpu")
        _check_static_equal(name, sp, analyze_app(cpu_app, cache=default_cache(cpu_app)))
        static = {r.index for r in sp.regions if r.decision == "persist"}
        measured = set(golden[name]["persist_regions"])
        if static == measured:
            agree.add(name)
        elif (sorted(static - measured), sorted(measured - static)) != STATIC_MISSES.get(name):
            raise AssertionError(f"{name}: static regions {sorted(static)} against measured "
                                 f"{sorted(measured)}, not the annotated miss")
        log(f"[static] {name} on {dev} in {out['analyze_ms'][name]:.1f} ms: regions "
            f"{[(r.name, r.traced, r.decision, round(r.confidence, 4), r.write_bytes) for r in sp.regions]}, "
            f"objects {[(o.name, o.klass, o.decision, o.damping) for o in sp.objects]}, "
            f"uncertain {sp.uncertain_regions()}; equal to the CPU's")
    if agree != STATIC_AGREE:
        raise AssertionError(f"static agreement {sorted(agree)}, want {sorted(STATIC_AGREE)}")

    with open(ADAPTIVE_GOLDENS) as f:
        adaptive = json.load(f)["sor"]
    app = ci_app("sor", device=dev)
    cache = default_cache(app)
    runs = (("static", "static", None, 0),
            ("static+verify", "static+verify", None, STATIC_VERIFY_TESTS),
            ("adaptive", "adaptive", None, adaptive["default_is"]["tests_executed"]),
            ("adaptive_exact", "adaptive", SequentialConfig(sampler_bias=0.0),
             adaptive["exact"]["tests_executed"]))
    out["tests_executed"] = {}
    for label, source, stopping, want in runs:
        t0 = time.perf_counter()
        wf = run_workflow(app, WorkflowConfig(n_tests=40, seed=0, cache=cache,
                                              plan_source=source, stopping=stopping))
        out["workflow_ms"][label] = (time.perf_counter() - t0) * 1e3
        out["tests_executed"][label] = wf.tests_executed
        log(f"[static] sor run_workflow {label} on {dev}: {wf.plan}, "
            f"{wf.tests_executed} tests in {out['workflow_ms'][label]:.1f} ms")
        if (wf.plan.objects, wf.plan.region_freq) != JAX_SOR_PLAN or wf.tests_executed != want:
            raise AssertionError(f"sor {label}: {wf.plan} after {wf.tests_executed} tests, "
                                 f"want {JAX_SOR_PLAN} after {want}")

    t0 = time.perf_counter()
    checked = 0
    for name in app_names():
        lapp = get_app(name, device=dev)
        if not lapp.supports_batched_step:
            continue
        for kname, findings in lint_app(lapp).items():
            checked += 1
            if findings:
                raise AssertionError(f"lint {name}/{kname}: {[str(x) for x in findings]}")
    out["lint_kernels"] = checked
    out["lint_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"[static] determinism lint on {dev}: {checked} kernels, 0 findings in "
        f"{out['lint_ms']:.1f} ms")
    if checked < 14:
        raise AssertionError(f"the lint checked {checked} kernels, want every app's 14")
    if WorkflowConfig().cache.block_bytes != BLOCK_BYTES:
        raise AssertionError("the default cache's block size is not the deployment's")

    big = SORApp(grid=DEPLOY_GRID, device=dev)
    t0 = time.perf_counter()
    # a static plan reads only the cache's block size (64 bytes, as the
    # deployment's), so the default cache spares an init of the 8192 grid
    wf = run_workflow(big, WorkflowConfig(seed=0, plan_source="static"))
    out["static_plan_ms"] = (time.perf_counter() - t0) * 1e3
    plan = wf.plan
    log(f"[static] sor's static plan at grid {DEPLOY_GRID} on {dev}: {plan}, "
        f"{wf.tests_executed} tests, {out['static_plan_ms']:.1f} ms")
    if (plan.objects, plan.region_freq) != JAX_SOR_PLAN or wf.tests_executed != 0:
        raise AssertionError(f"sor's static plan at grid {DEPLOY_GRID}: {plan}")
    dirty_block_mask.launches = 0
    out["deploy"] = phase_deploy(dev, plan, "the static plan", app=big)
    out["delta_launches"] = dirty_block_mask.launches
    want = delta_launches_expected(plan)
    if out["delta_launches"] != want:
        raise AssertionError(f"delta_snapshot launched {out['delta_launches']} times on the "
                             f"static plan's deployment, expected {want}")
    return out


# ----------------------------- 19. the examples, the dry-run, elastic restore
#: runs one example in a fresh interpreter; prints its kernel launches and
#: the jax modules it loaded
_EXAMPLE_RUN = """
import json, runpy, sys
from repro_torch.kernels.delta_snapshot import dirty_block_mask
from repro_torch.kernels.flash_attention import flash_attention
sys.argv = [PATH] + ARGS
try:
    runpy.run_path(PATH, run_name='__main__')
finally:
    bad = sorted(m for m in sys.modules if m in ('jax', 'repro')
                 or m.startswith(('jax.', 'jaxlib', 'repro.')))
    print('LAUNCHES ' + json.dumps({'flash_attention': flash_attention.launches,
                                    'delta_snapshot': dirty_block_mask.launches,
                                    'jax_modules': bad}))
"""


def _start_example(name: str, args: tuple, device: str, tmp: str) -> subprocess.Popen:
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    code = f"PATH = {path!r}\nARGS = {list(args) + ['--device', device]!r}\n" + _EXAMPLE_RUN
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), TMPDIR=tmp)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen([sys.executable, "-c", code], cwd=tmp, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _plan_lines(name: str, out: str) -> list:
    lines = re.findall(EXAMPLE_PLAN_LINES[name], out, re.M)
    if not lines:
        raise AssertionError(f"example {name}: no plan in its report:\n{out[-3000:]}")
    return lines


#: the serving example's prefill attention (B, S, H, D): StableLM-2-1.6B at
#: width 128 has 4 heads of 32, which the kernel runs padded to D 64
EXAMPLE_ATTN_SHAPE = (4, 32, 4, 32)


def _check_example_attention(dev: str) -> float:
    """flash_attention at the serving example's shape against its plain
    version, in float32 and bfloat16 (tests/test_kernels.py's tolerances)."""
    gen = torch.Generator(device=dev).manual_seed(19)
    err = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = _attn_inputs(gen, EXAMPLE_ATTN_SHAPE, EXAMPLE_ATTN_SHAPE[2], dtype)
        want = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=True).transpose(1, 2)
        err = max(err, _check_close(f"flash_attention {dtype} at {EXAMPLE_ATTN_SHAPE}",
                                    flash_attention(q, k, v).float(), want.float(), tol))
    return err


def _example_serve_stream(dev: str, tmp: str) -> None:
    """The serving example's resumed stream (its arena's tokens after the
    last flush) against an uninterrupted serve of the same flags."""
    arena = NVMArena.reattach(os.path.join(tmp, "repro_torch_example_serve", "serve_arena"))
    resumed = arena.get("tokens")
    args = serve.parser().parse_args([*EXAMPLE_SERVE_FLAGS, "--device", dev,
                                      "--workdir", os.path.join(tmp, "uninterrupted")])
    whole = serve.run(args)["tokens"]
    if int(arena.get("__step__")) != 48 or not np.array_equal(resumed, whole):
        raise AssertionError("the serving example's resumed stream differs from an "
                             "uninterrupted serve of its flags")


def phase_examples(dev: str) -> dict:
    """Phase 19 (a): the six examples on the card and on the CPU at once."""
    root = os.path.join(ROOT, "build", "chip_smoke_examples")
    shutil.rmtree(root, ignore_errors=True)
    attn_err = _check_example_attention(dev)
    log(f"[examples] flash_attention at the serving example's shape {EXAMPLE_ATTN_SHAPE} "
        f"(D 32, run at 64): max |kernel - plain| {attn_err:.3e}")
    t0 = time.perf_counter()
    procs = {(name, device): _start_example(name, args, device, os.path.join(root, device, name))
             for name, args in EXAMPLES for device in (dev, "cpu")}
    outs = {}
    try:
        for key, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"example {key[0]} on {key[1]} exited {proc.returncode}:\n"
                                     f"{out[-3000:]}")
            outs[key] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    result = {"seconds": time.perf_counter() - t0, "flash_launches": 0, "delta_launches": 0,
              "flash_max_abs_err": attn_err, "by_example": {}}
    for name, _ in EXAMPLES:
        card, cpu = outs[(name, dev)], outs[(name, "cpu")]
        counts = [json.loads(l[len("LAUNCHES "):]) for l in (card, cpu)
                  for l in l.splitlines() if l.startswith("LAUNCHES ")]
        if len(counts) != 2 or counts[0]["jax_modules"] or counts[1]["jax_modules"]:
            raise AssertionError(f"example {name}: loaded jax or reported no launches {counts}")
        if _plan_lines(name, card) != _plan_lines(name, cpu):
            raise AssertionError(f"example {name}: the card's plan {_plan_lines(name, card)} "
                                 f"differs from the CPU's {_plan_lines(name, cpu)}")
        result["by_example"][name] = {"plan": _plan_lines(name, card),
                                      "flash_attention": counts[0]["flash_attention"],
                                      "delta_snapshot": counts[0]["delta_snapshot"]}
        result["flash_launches"] += counts[0]["flash_attention"]
        result["delta_launches"] += counts[0]["delta_snapshot"]
        log(f"[examples] {name}: exit 0 on {dev} and cpu, plan {_plan_lines(name, card)}; "
            f"flash_attention {counts[0]['flash_attention']}, delta_snapshot "
            f"{counts[0]['delta_snapshot']} launches on {dev}")
    by = result["by_example"]
    if by["serve_recovery"]["flash_attention"] == 0 or by["serve_recovery"]["delta_snapshot"] == 0:
        raise AssertionError("the serving example launched no flash_attention or no delta_snapshot")
    if by["train_lm"]["delta_snapshot"] == 0:
        raise AssertionError("the training example launched no delta_snapshot")
    _example_serve_stream(dev, os.path.join(root, dev, "serve_recovery"))
    log(f"[examples] serve_recovery: the resumed stream equals an uninterrupted serve; "
        f"six examples in {result['seconds']:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return result


def phase_dryrun_h100(dev: str) -> dict:
    """Phase 19 (b): the dry-run's "h100" cell at phase 15's trainer, then one
    real step of the trainer profiled against its roofline bound."""
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    mesh = mesh_for_name("h100")
    try:
        res = dryrun.cell(cfg, DRYRUN_SHAPE, mesh)
    finally:
        release()
    r = res["roofline"]
    log(f"[dryrun] h100 cell {TRAIN_ARCH} x {TRAIN_LAYERS} layers, batch "
        f"{DRYRUN_SHAPE.global_batch} x {DRYRUN_SHAPE.seq_len}: flops {r['flops_per_device']:.4e}, "
        f"bytes {r['bytes_per_device']:.4e}, compute {r['compute_s'] * 1e3:.3f} ms, memory "
        f"{r['memory_s'] * 1e3:.3f} ms, collective {r['collective_s'] * 1e3:.3f} ms, dominant "
        f"{r['dominant']}, useful {r['useful_ratio']:.4f}, peak {res['bytes_per_device']:.0f} B; "
        f"counted step {res['compile_s']} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prof = _profile_train_steps(cfg, dev)
    peak = torch.cuda.max_memory_allocated()
    if not prof["device_ms"]:
        raise AssertionError("the profiler reported no device time: the bound cannot be checked")
    measured_s = prof["device_ms"] / prof["steps"] / 1e3
    bound_s = max(r["compute_s"], r["memory_s"])
    out = {"roofline": r, "predicted_peak_bytes": res["bytes_per_device"],
           "measured_device_s": measured_s, "bound_s": bound_s,
           "measured_peak_bytes": peak, "counted_step_s": res["compile_s"]}
    log(f"[dryrun] measured {measured_s * 1e3:.3f} ms of device time per step against the "
        f"bound {bound_s * 1e3:.3f} ms (predicted / measured {bound_s / measured_s:.4f}); peak "
        f"predicted {res['bytes_per_device']:.0f} B / measured {peak} B "
        f"({res['bytes_per_device'] / peak:.4f})")
    if measured_s < bound_s:
        raise AssertionError(f"a step took {measured_s * 1e3:.3f} ms of device time, under its "
                             f"roofline bound {bound_s * 1e3:.3f} ms: the count is wrong")
    return out


# -------------------------------------------- 20. the dry-run's kernel cells
def _kernel_launches() -> dict:
    return {"rwkv6_scan": rwkv6_scan.launches, "rglru_scan": rglru_scan.launches,
            "flash_attention": flash_attention.launches}


def _zero_kernel_launches() -> None:
    rwkv6_scan.launches = rglru_scan.launches = flash_attention.launches = 0


def _cut_groups(cfg, reps: int):
    """``cfg`` with its first layer group cut to ``reps`` repetitions and the
    other groups dropped."""
    pattern = cfg.groups[0][0]
    return dataclasses.replace(cfg, n_layers=len(pattern) * reps, layer_groups=((pattern, reps),))


def _ops_on_dtensors(dev: str, mesh) -> dict:
    """Each model kernel's op on seeded inputs at the cells' shapes, called
    on 1 x 1 DTensors of the card and directly: the same bits."""
    from torch.distributed.tensor import DTensor, Replicate

    gen = torch.Generator(device=dev).manual_seed(20)

    def both(fn, *xs):
        direct = fn(*xs)
        dts = [DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
               for x in xs]
        via = fn(*dts)
        direct, via = ((t,) if isinstance(t, torch.Tensor) else t for t in (direct, via))
        return all(torch.equal(a, b.to_local()) for a, b in zip(direct, via))

    r, k, v = (torch.randn(RWKV_SHAPE, generator=gen, device=dev) for _ in range(3))
    w = torch.rand(RWKV_SHAPE, generator=gen, device=dev) * 0.5 + 0.5
    u = torch.randn(RWKV_SHAPE[2:], generator=gen, device=dev)
    a = torch.rand(RGLRU_SHAPE, generator=gen, device=dev)
    x = torch.randn(RGLRU_SHAPE, generator=gen, device=dev)
    out = {"rwkv6_scan": both(lambda *t: rwkv6_scan(*t, return_state=True), r, k, v, w, u),
           "rglru_scan": both(rglru_scan, a, x)}
    for name, shape, window in (("flash_attention_rg", RG_ATTN_SHAPE, 2048),
                                ("flash_attention_qwen", QWEN_ATTN_SHAPE, None)):
        q, kk, vv = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
                     for _ in range(3))
        out[name] = both(lambda *t: flash_attention(*t, window=window), q, kk, vv)
    return out


def phase_dryrun_kernels(dev: str) -> dict:
    """Phase 20: the dry-run's cells with impl="kernel" on the "h100" mesh
    (a 1 x 1 DTensor mesh of the card), at the served cells' prefill shape,
    for RWKV6-3B cut to 4 layers, RecurrentGemma-9B to one (rec, rec, attn)
    repetition and Qwen1.5-MoE-A2.7B to 2 layers, all at full width.  Each
    cell must launch every model kernel once per layer of its kind; its
    roofline bound must not exceed the device time of a profiled prefill
    of the same configuration on plain tensors (random bf16 weights); and
    each op on 1 x 1 DTensors must give the direct call's bits."""
    t0 = time.perf_counter()
    gpu = gpu_name_and_power()
    mesh = mesh_for_name("h100")
    cells, by_path = {}, {k: 0 for k in KERNEL_KIND}
    try:
        for label, arch, reps in DRYRUN_KERNEL_CELLS:
            cfg = _cut_groups(get_arch(arch), reps)
            want = {k: sum(pat.count(kind) * rep for pat, rep in cfg.groups)
                    for k, kind in KERNEL_KIND.items()}
            _zero_kernel_launches()
            res = dryrun.cell(cfg, DRYRUN_PREFILL, mesh, impl="kernel")
            launches = _kernel_launches()
            if launches != want:
                raise AssertionError(f"{label}: the cell launched {launches}, expected once "
                                     f"per layer of each kernel's kind: {want}")
            for k, n in launches.items():
                by_path[k] += n
            r = res["roofline"]
            bound_s = max(r["compute_s"], r["memory_s"])
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
            tokens = torch.randint(0, cfg.vocab, (SERVE_PROMPTS, SERVE_PROMPT_LEN),
                                   generator=torch.Generator(device=dev).manual_seed(1),
                                   device=dev, dtype=torch.int32)

            def one():
                prefill(cfg, params, tokens, impl="kernel")

            one()  # warm-up
            prof = _kernel_profile(one, 1)
            del params
            torch.cuda.empty_cache()
            if not prof["device_ms"]:
                raise AssertionError(f"{label}: the profiler reported no device time")
            measured_s = prof["device_ms"] / 1e3
            cells[label] = {"arch": arch, "layers": cfg.n_layers, "launches": launches,
                            "flops": r["flops_per_device"], "bytes": r["bytes_per_device"],
                            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                            "bound_s": bound_s, "measured_device_s": measured_s,
                            "bound_over_measured": bound_s / measured_s,
                            "peak_bytes": res["bytes_per_device"],
                            "counted_step_s": res["compile_s"]}
            log(f"[dryrun20] {label} ({gpu}): launches {launches}; flops "
                f"{r['flops_per_device']:.4e}, bytes {r['bytes_per_device']:.4e}, compute "
                f"{r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} ms; bound "
                f"{bound_s * 1e3:.3f} ms against {measured_s * 1e3:.3f} ms of device time in a "
                f"profiled prefill ({bound_s / measured_s:.4f}); wall of the prefill "
                f"{prof['wall_ms']:.1f} ms; peak {res['bytes_per_device']:.0f} B")
            if measured_s < bound_s:
                raise AssertionError(f"{label}: a prefill took {measured_s * 1e3:.3f} ms of "
                                     f"device time, under its roofline bound "
                                     f"{bound_s * 1e3:.3f} ms: the count is wrong")
        bits = _ops_on_dtensors(dev, mesh)
    finally:
        release()
    if not all(bits.values()):
        raise AssertionError(f"an op on 1 x 1 DTensors differs from its direct call: {bits}")
    seconds = time.perf_counter() - t0
    log(f"[dryrun20] ({gpu}) each op on 1 x 1 DTensors gives the direct call's bits "
        f"({', '.join(bits)}); phase 20 {seconds:.1f} s")
    return {"cells": cells, "launches_by_kernel": by_path, "dtensor_bits": bits,
            "seconds": seconds}


# ----------------------------------------------- 21. the padded head layout
def _padded_slots(cfg, kind: str, n_heads: int) -> torch.Tensor:
    """The padded heads' indices among ``n_heads`` (models/padding.py)."""
    if kind == "rwkv":
        real = cfg.d_model // cfg.rwkv.head_dim
        return torch.arange(real, n_heads)
    groups, per, per_padded = q_groups(cfg, n_heads)
    return torch.tensor([g * per_padded + i for g in range(groups)
                         for i in range(per, per_padded)])


def _padded_prefill(cfg, params, prompts, kind: str, n_heads: int, dev: str):
    """A kernel prefill of the padded model, with the largest magnitude in
    its padded heads' outputs before the output projection (every layer's,
    as heads_merged receives them: (B, S, H, D))."""
    seen = []
    slots = _padded_slots(cfg, kind, n_heads).to(dev)
    module = attention if kind == "attn" else rwkv6

    def wrap(fn):
        def merged(x):
            seen.append(x.index_select(-2, slots).abs().amax())
            return fn(x)
        return merged

    with _patched(module, "heads_merged", wrap):
        logits, cache = prefill(cfg, params, prompts, impl="kernel")
    if len(seen) != cfg.n_layers:
        raise AssertionError(f"{len(seen)} padded outputs recorded, expected {cfg.n_layers}")
    return logits, cache, float(torch.stack(seen).max())


def _padded_model(label: str, arch: str, layers: int, kernel: str, dev: str) -> dict:
    """One model of phase 21: float32 logits and bf16 greedy streams,
    padded against unpadded, the padded heads' outputs, the launches."""
    cfg = _cut_groups(get_arch(arch), layers)
    kind = cfg.groups[0][0][0]
    if kind == "rwkv":
        real, heads = cfg.d_model // cfg.rwkv.head_dim, rwkv_heads(cfg, PAD_SPLIT)
    else:
        real, heads = cfg.n_heads, attn_heads(cfg, PAD_SPLIT)
    counter = {"flash_attention": flash_attention, "rwkv6_scan": rwkv6_scan}[kernel]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    prompts = serve.make_prompts(cfg, SERVE_PROMPTS, SERVE_PROMPT_LEN, dev)
    counter.launches = 0

    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _tree_map(params, lambda x: x.float())
    want, _ = prefill(c32, p32, prompts, impl="kernel")
    got, _, pad32 = _padded_prefill(c32, pad_params(c32, p32, PAD_SPLIT), prompts, kind,
                                    heads, dev)
    del p32
    torch.cuda.empty_cache()
    scale = float(want.abs().max())
    f32_rel = float((got - want).abs().max()) / scale
    if f32_rel > PAD_F32_TOL:
        raise AssertionError(f"{label}: float32 padded prefill logits differ from the "
                             f"unpadded ones by {f32_rel:.3e} of the largest, over "
                             f"{PAD_F32_TOL}")

    logits, pcache = prefill(cfg, params, prompts, impl="kernel")
    plain = _greedy(cfg, params, logits, pcache, PAD_DECODE_STEPS)
    del pcache
    padded = pad_params(cfg, params, PAD_SPLIT)
    logits_p, pcache, pad16 = _padded_prefill(cfg, padded, prompts, kind, heads, dev)
    after = {}
    stream = _greedy(cfg, padded, logits_p, pcache, PAD_DECODE_STEPS, split=PAD_SPLIT,
                     into=after)
    launches = counter.launches
    state_pad = 0.0
    if kind == "rwkv":
        S = after["cache"]["group0"]["pos0"]["S"]
        state_pad = float(S[:, :, real:].abs().max())
    del pcache, after, padded, params
    torch.cuda.empty_cache()
    same = torch.equal(plain, stream)
    if not same:
        diff = (plain != stream).nonzero()
        raise AssertionError(f"{label}: the padded bf16 greedy stream leaves the unpadded one "
                             f"at {diff[:4].tolist()}")
    if pad32 != 0.0 or pad16 != 0.0 or state_pad != 0.0:
        raise AssertionError(f"{label}: padded heads are not 0: before the output projection "
                             f"{pad32} (f32), {pad16} (bf16); RWKV state {state_pad}")
    want_launches = 4 * cfg.n_layers  # four prefills (f32 and bf16, each padded and not)
    if launches != want_launches:
        raise AssertionError(f"{label}: {kernel} launched {launches} times, expected "
                             f"{want_launches} (once per layer of four prefills)")
    log(f"[pad21] {label}: {arch} cut to {cfg.n_layers} layers, {real} -> {heads} heads "
        f"over {PAD_SPLIT}: float32 prefill logits {tuple(want.shape)} padded vs unpadded max "
        f"|diff| {f32_rel:.3e} of the largest ({scale:.2f}); bf16 greedy streams "
        f"{tuple(stream.shape)} equal; padded heads' outputs before the output projection "
        f"0 in every layer" + (f", padded state 0 after {PAD_DECODE_STEPS} steps"
                               if kind == "rwkv" else "") + f"; {kernel} {launches} launches")
    return {"arch": arch, "layers": cfg.n_layers, "heads": real, "padded_heads": heads,
            "f32_rel_diff": f32_rel, "greedy_equal": same, "kernel": kernel,
            "launches": launches}


def phase_padded_heads(dev: str) -> dict:
    """Phase 21: the production meshes' padded head layout on plain tensors
    of the card, at full width (see the module docstring)."""
    t0 = time.perf_counter()
    models = {label: _padded_model(label, arch, layers, kernel, dev)
              for label, arch, layers, kernel in PAD_MODELS}
    seconds = time.perf_counter() - t0
    log(f"[pad21] ({gpu_name_and_power()}) phase 21 {seconds:.1f} s")
    return {"models": models, "seconds": seconds,
            "launches": {m["kernel"]: m["launches"] for m in models.values()}}


def phase_reshard(cfg, dev: str, wd: str) -> dict:
    """Phase 19 (c), inside phase 15: the newest checkpoint through
    reshard_restore onto the "h100" mesh, against launch/train.py's own
    restore, one train step from each."""
    t0 = time.perf_counter()
    ckpt = CheckpointManager(CheckpointConfig(local_dir=os.path.join(wd, "ckpt_local"),
                                              remote_dir=os.path.join(wd, "ckpt_remote")))
    step, tree = ckpt.restore()
    ckpt.close()
    mesh = mesh_for_name("h100")
    try:
        placed = reshard_restore(tree, train_state_specs(cfg, 1), mesh)
        local = _tree_map(placed, lambda t: t.to_local())
    finally:
        release()
    _check_state_equals("reshard_restore", local, flatten_tree(tree))
    del tree, placed

    # launch/train.py's own restore of the same checkpoint: the arena is
    # rejected (--verify-loss-max 0) and no flush or checkpoint is taken
    restored = {}

    def on_restore(state, got, source):
        if (source, got) != ("checkpoint", step):
            raise AssertionError(f"train.py restored from {source} at {got}, not step {step}")
        restored["state"] = _tree_map(state, torch.clone)

    args = _train_args(wd, "--steps", str(step + 1), "--verify-loss-max", "0",
                       "--flush-every", "1000000000", "--mtbf", "1e12")
    train.run(args, cfg, on_restore=on_restore)
    _, data_cfg, step_fn = train.build(args, cfg)
    stream = SyntheticLMStream(data_cfg, 0, 1, start_step=step)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream)[1].items()}
    stream.close()
    a = flatten_state(step_fn(restored.pop("state"), batch)[0])
    b = flatten_state(step_fn(local, batch)[0])
    if set(a) != set(b):
        raise AssertionError(f"the two steps' states differ in leaves {sorted(set(a) ^ set(b))}")
    for name, x in a.items():
        y = b[name]
        if x.dtype != y.dtype or not torch.equal(x.reshape(-1).view(torch.uint8),
                                                 y.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{name}: a step from reshard_restore's state differs from a "
                                 "step from train.py's restore")
    leaves = len(a)
    del a, b, local
    torch.cuda.empty_cache()
    out = {"step": step, "leaves": leaves, "seconds": time.perf_counter() - t0}
    log(f"[reshard] checkpoint of step {step} placed on the h100 mesh: every leaf equal to its "
        f"bytes; one step from it equals one step from train.py's restore, bit for bit "
        f"({leaves} leaves), {out['seconds']:.1f} s")
    return out


# ------------------------------------------------- 22. Granite-4.0-H-Micro
def ssm_bound_ms(b: int, h: int, p: int, n: int, g: int) -> float:
    """Least time of one ``ssm_update``: the float32 state read and written
    once, x and y, dt, A and D, B and C, at the device-memory rate."""
    return 4 * (2 * b * h * p * n + 2 * b * h * p + b * h + 2 * h + 2 * b * g * n) \
        / HBM_BYTES_PER_S * 1e3


def _ssm_inputs(gen, b: int, h: int, p: int, n: int, g: int) -> tuple:
    """A state of a decode's scale and one token's inputs: (h, x, dt, A, B,
    C, D), A and dt as Mamba-2's initialisation draws them."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    return (r(b, h, p, n) * 0.1, r(b, h, p), F.softplus(r(b, h) - 4),
            -(1 + 15 * torch.rand(h, generator=gen, device=gen.device)), r(b, g, n),
            r(b, g, n), r(h))


def phase_ssm_update_kernel(dev: str) -> dict:
    gen = torch.Generator(device=dev).manual_seed(22)
    err_h = err_y = 0.0
    for shape in SSM_CASES:
        h, x, dt, A, B, C, D = _ssm_inputs(gen, *shape)
        want_h = h.clone()
        want_y = ssm_update_reference(want_h, x, dt, A, B, C, D)
        before = ssm_update.launches
        y = ssm_update(h, x, dt, A, B, C, D)
        torch.cuda.synchronize()
        if ssm_update.launches != before + 1:
            raise AssertionError(f"ssm_update {shape}: the call did not count one launch")
        err_h = max(err_h, _check_close(f"ssm_update state {shape}", h, want_h, SSM_STATE_TOL))
        err_y = max(err_y, _check_close(f"ssm_update output {shape}", y, want_y, SSM_OUT_TOL))
    log(f"[ssm] ssm_update equals its plain version in {len(SSM_CASES)} shapes: max |diff| "
        f"state {err_h:.3e} (tolerance {SSM_STATE_TOL}), output {err_y:.3e} ({SSM_OUT_TOL})")
    ptxas = _check_ptxas("ssm_update")
    h, x, dt, A, B, C, D = _ssm_inputs(gen, *SSM_CASES[0])
    ms = cuda_ms(lambda: ssm_update(h, x, dt, A, B, C, D), reps=200, warmup=5)
    plain_ms = cuda_ms(lambda: ssm_update_reference(h, x, dt, A, B, C, D), reps=20)
    bound = ssm_bound_ms(*SSM_CASES[0])
    log(f"[ssm] ssm_update at (B, H, P, N, G) = {SSM_CASES[0]} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes; {bound / ms:.1%} of the bound)")
    del h, x, dt, A, B, C, D
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "max_abs_err": max(err_h, err_y), "ptxas": ptxas}


def phase_serve_granite(dev: str) -> dict:
    cfg = get_arch(GRANITE_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    prompts = serve.make_prompts(cfg, SERVE_PROMPTS, SERVE_PROMPT_LEN, dev)
    kinds = [kind for pattern, n in cfg.groups for kind in pattern * n]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    dirty_block_mask.launches = flash_attention.launches = ssm_update.launches = 0
    runs = _serve_and_resume("granite", GRANITE_ARCH, params, prompts)
    launches = {"ssm_update": ssm_update.launches, "flash_attention": flash_attention.launches,
                "delta_snapshot": dirty_block_mask.launches}
    # decode steps: 64 uninterrupted, 32 before the crash, 32 resumed; two prefills
    want = {"ssm_update": n_mamba * (SERVE_STEPS + SERVE_CRASH_AT + SERVE_STEPS - SERVE_CRASH_AT),
            "flash_attention": 2 * n_attn}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"granite: {name} launched {launches[name]} times, expected {n}")
    _check_delta_launches("granite", cfg, launches["delta_snapshot"])
    del params
    torch.cuda.empty_cache()
    return _serve_summary("granite", runs, {"launches": launches, "mamba_layers": n_mamba,
                                            "attention_layers": n_attn})


def _ssm_entry(kern: dict, granite: dict) -> dict:
    return {
        "name": "ssm_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_update.cu",
        "replaces": None,
        "launches": granite["launches"]["ssm_update"],
        "launches_by_path": {"serve_granite": granite["launches"]["ssm_update"]},
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,
        "ptxas": kern["ptxas"],
    }


def _ok_line() -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port's main path on one NVIDIA card.")
    ap.add_argument("--only", choices=("granite",), help="run phases 1 and 22 alone")
    only = ap.parse_args().only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")  # also sets the matmul precision flags
    # a campaign whose lane driver breaks must fail, not fall back quietly
    warnings.filterwarnings("error", message=".*advance_lanes raised", category=RuntimeWarning)
    t_start = time.perf_counter()
    gpu = phase_environment()
    if only == "granite":
        ssm_k = phase_ssm_update_kernel(dev)
        granite = phase_serve_granite(dev)
        log(gpu)
        print(json.dumps({"kernels": [_ssm_entry(ssm_k, granite)]}), flush=True)
        print(_ok_line(), flush=True)
        return 0
    max_err = check_kernel(dev)
    kern = time_kernel(dev)

    dirty_block_mask.launches = 0
    plan = phase_characterize(dev)
    deploy = phase_deploy(dev, plan)
    launches = dirty_block_mask.launches
    want = delta_launches_expected(plan)
    if launches != want:
        raise AssertionError(f"delta_snapshot launched {launches} times on the main path, "
                             f"expected one per leaf and delta flush ({want})")
    log(f"[deploy] summary {json.dumps(deploy)}")

    flash = phase_flash(dev)
    phase_decode_characterize(dev)
    served = phase_serve(dev)
    log(f"[serve] summary {json.dumps(served)}")
    torch.cuda.empty_cache()

    rwkv_k = phase_rwkv_kernel(dev)
    rglru_k = phase_rglru_kernel(dev)
    rwkv = phase_serve_rwkv(dev)
    log(f"[rwkv] summary {json.dumps(rwkv)}")
    rg = phase_serve_rg(dev)
    log(f"[rg] summary {json.dumps(rg)}")

    t0 = time.perf_counter()
    plans = phase_characterize_suite(dev)
    plans["lm-train"] = phase_characterize_lm_train(dev)
    t1 = time.perf_counter()
    suite = phase_deploy_suite(dev, plans)
    log(f"[suite] characterization {t1 - t0:.1f} s, deployments "
        f"{time.perf_counter() - t1:.1f} s")

    t0 = time.perf_counter()
    slice7 = phase_slice7(dev)
    log(f"[slice7] phase A timings {json.dumps(slice7['phase_a'])}")
    t1 = time.perf_counter()
    slice7_deploy = phase_deploy_slice7(dev, slice7["plans"])
    suite.update(slice7_deploy)
    log(f"[slice7] characterization {t1 - t0:.1f} s, deployments "
        f"{time.perf_counter() - t1:.1f} s")

    t0 = time.perf_counter()
    trained = phase_train(dev)
    log(f"[train] summary {json.dumps(trained)}")
    t1 = time.perf_counter()
    fleet = phase_fleet(served)
    log(f"[fleet] summary {json.dumps(fleet)}")
    log(f"[slice8] phase 15 {t1 - t0:.1f} s, phase 16 {time.perf_counter() - t1:.1f} s")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    qwen = phase_serve_moe(dev)
    log(f"[qwen] summary {json.dumps(qwen)}")
    scout = phase_scout(dev)
    log(f"[scout] summary {json.dumps(scout)}")
    qwen_attn = flash["by_path"]["serve_qwen2_moe"]
    log(f"[slice9] flash_attention at Qwen's shape {qwen_attn['shape']}: kernel "
        f"{qwen_attn['ms']:.4f} ms, SDPA {qwen_attn['library_ms']:.4f} ms, plain "
        f"{qwen_attn['plain_ms']:.4f} ms, bound {qwen_attn['bound_ms']:.4f} ms "
        f"({qwen_attn['bound_by']}; phase 5)")
    log(f"[slice9] phase 17 {time.perf_counter() - t0:.1f} s; "
        f"the whole run {time.perf_counter() - t_start:.1f} s")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    static = phase_static(dev)
    log(f"[static] summary {json.dumps(static)}")
    log(f"[slice10] phase 18 {time.perf_counter() - t0:.1f} s; "
        f"the whole run {time.perf_counter() - t_start:.1f} s")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    examples = phase_examples(dev)
    log(f"[examples] summary {json.dumps(examples)}")
    dry = phase_dryrun_h100(dev)
    log(f"[dryrun] summary {json.dumps(dry)}")
    log(f"[slice11] phase 19 {time.perf_counter() - t0:.1f} s (its (c) ran in phase 15: "
        f"{trained['reshard']['seconds']:.1f} s); the whole run "
        f"{time.perf_counter() - t_start:.1f} s")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    dry20 = phase_dryrun_kernels(dev)
    log(f"[dryrun20] summary {json.dumps(dry20)}")
    log(f"[slice12] phase 20 {time.perf_counter() - t0:.1f} s; the whole run "
        f"{time.perf_counter() - t_start:.1f} s")
    d20 = dry20["launches_by_kernel"]

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    pad21 = phase_padded_heads(dev)
    log(f"[pad21] summary {json.dumps(pad21)}")
    log(f"[slice13] phase 21 {time.perf_counter() - t0:.1f} s; the whole run "
        f"{time.perf_counter() - t_start:.1f} s")
    p21 = pad21["launches"]

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ssm_k = phase_ssm_update_kernel(dev)
    granite = phase_serve_granite(dev)
    log(f"[granite] phase 22 {time.perf_counter() - t0:.1f} s; the whole run "
        f"{time.perf_counter() - t_start:.1f} s")

    log(gpu)
    print(json.dumps({"kernels": [{
        "name": "delta_snapshot",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_snapshot.cu",
        "replaces": "src/repro/kernels/delta_snapshot/kernel.py:26",
        "launches": launches + served["delta_launches"] + rwkv["delta_launches"]
        + rg["delta_launches"] + sum(r["delta_launches"] for r in suite.values())
        + trained["delta_launches"] + qwen["delta_launches"] + static["delta_launches"]
        + examples["delta_launches"],
        "launches_by_path": {"sor_deploy": launches, "serve_stablelm": served["delta_launches"],
                             "serve_rwkv6": rwkv["delta_launches"],
                             "serve_recurrentgemma": rg["delta_launches"],
                             **{f"{name.replace('-', '_')}_deploy": r["delta_launches"]
                                for name, r in suite.items()},
                             "train_stablelm": trained["delta_launches"],
                             "serve_qwen2_moe": qwen["delta_launches"],
                             "sor_static_deploy": static["delta_launches"],
                             "examples": examples["delta_launches"]},
        "max_abs_err": max_err,
        "exact": max_err == 0,
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
        "launches": served["flash_launches"] + rg["flash_launches"] + qwen["flash_launches"]
        + scout["flash_launches"] + examples["flash_launches"] + d20["flash_attention"]
        + p21["flash_attention"],
        "launches_by_path": {"serve_stablelm": served["flash_launches"],
                             "serve_recurrentgemma": rg["flash_launches"],
                             "serve_qwen2_moe": qwen["flash_launches"],
                             "llama4_scout_prefill": scout["flash_launches"],
                             "examples": examples["flash_launches"],
                             "dryrun_h100": d20["flash_attention"],
                             "padded_heads": p21["flash_attention"]},
        "max_abs_err": max(flash["max_abs_err"], examples["flash_max_abs_err"]),
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "by_path": flash["by_path"],
        "ptxas": flash_ptxas(),
    }, {
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:28",
        "launches": rwkv["rwkv6_launches"] + d20["rwkv6_scan"] + p21["rwkv6_scan"],
        "launches_by_path": {"serve_rwkv6": rwkv["rwkv6_launches"],
                             "dryrun_h100": d20["rwkv6_scan"],
                             "padded_heads": p21["rwkv6_scan"]},
        "max_abs_err": rwkv_k["max_abs_err"],
        "ms": rwkv_k["ms"],
        "plain_ms": rwkv_k["plain_ms"],
        "bound_ms": rwkv_k["bound_ms"],
        "bound_by": rwkv_k["bound_by"],
        "library_ms": None,
        "state_max_abs_err": rwkv_k["state_max_abs_err"],
        "ptxas": rwkv_k["ptxas"],
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:22",
        "launches": rg["rglru_launches"] + d20["rglru_scan"],
        "launches_by_path": {"serve_recurrentgemma": rg["rglru_launches"],
                             "dryrun_h100": d20["rglru_scan"]},
        "max_abs_err": rglru_k["max_abs_err"],
        "ms": rglru_k["ms"],
        "plain_ms": rglru_k["plain_ms"],
        "bound_ms": rglru_k["bound_ms"],
        "bound_by": rglru_k["bound_by"],
        "library_ms": None,
        "exact": rglru_k["exact"],
        "ptxas": rglru_k["ptxas"],
    }, _ssm_entry(ssm_k, granite)]}), flush=True)
    print(_ok_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
