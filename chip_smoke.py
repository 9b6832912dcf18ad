#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # from the root of the checkout

Phases, each printing one JSON object on a line of its own; any failure
raises and the script exits non-zero:

1. ``env``     -- the card (name, power limit), torch/CUDA versions, TF32 setting.
2. ``build``   -- compiles ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
   (one process per source, all at once).
3. ``kernels`` -- calls each kernel's wrapper at the shapes the model paths
   give it (glm4-9b's and qwen3-moe-235b-a22b's serving, zamba2-2.7b's
   prefill, minicpm-2b's, zamba2-2.7b's, qwen3-moe's and phi-3-vision-4.2b's
   training steps, the last with flash attention at head dim 96 on both
   routes; xlstm-350m's norms and whisper-tiny's, with its flash attention
   without a causal mask over 1500 frames and across 448 queries to 1500
   keys, forward and backward on both routes; dbrx-132b's, granite-8b's and
   phi4-mini-3.8b's prefill at GQA 6:1, 4:1 and 3:1, phi4-mini's training
   step's flash forward with lse and backward and its norms; a rank's shards
   of glm4-9b's step on four cards, flash at GQA 16:1 with one KV head,
   forward with lse and backward; of dbrx-132b's, flash at GQA 6:1 on 4 KV
   heads, forward with lse and backward, its norms at d 6144 forward and
   backward and its four-card decodes' norms (8 and 4 lanes); plus ragged,
   unaligned and small cases), holds
   the result against the plain PyTorch version on the same inputs, and times
   kernel, plain version and the one PyTorch library call that computes the
   same function (a yardstick; the port never calls it; none exists for the
   SSD scan or its backward; for a backward, its autograd backward with the
   forward outside the timed region) with CUDA events after warm-up; checks
   the route each launch plan took (flash, RMSNorm, and the SSD scan's route,
   sequence segments and heads per block; its backward's route, with the
   bf16 terms of its fp32 operands and each pass's blocks), that the flash forward's out is
   bit-identical with and without its log-sum-exp, and that two calls of any
   backward on the same inputs agree bit for bit; the RMSNorm backward's two
   kernels (row pass, dscale pass) are also timed apart with torch.profiler.
4. ``parity``  -- glm4-9b at full width, 4 layers: one padded prefill and a few
   decode steps, logits through the kernels against logits through the plain
   versions, in fp32 and in bf16.
5. ``placement`` -- the scheduling core (``repro_torch.core``) on the card's
   host, before serving as ``examples/serve.py`` orders it: two glm4-9b
   replicas (TP 8, PP 2) through ``place_replicas`` on a 4 x 4 cluster (no
   overlap, ``release`` restores every node); the "hier" tier at
   ``bench_latency``'s workload (104 x 96 nodes, a 4096-GPU gpt-7b job, a
   1 s budget): cold, flat MILP, warm re-solve after one node fails, the same
   request again (hier within 1.1 x the flat weighted spread, "hier-warm",
   "hier-cached"); a 9600-GPU job (TP 8, PP 8) on that cluster with 30 % of
   its nodes taken through each of the six built-in policies, and the Arnold
   rank grid of the "hier" placement (every TP group inside one node).  Its
   times are the host CPU's, printed beside the card.
6. ``simulate`` -- Arnold's evaluation path on the card's host (no device
   work): ``bench_sim``'s month (100 000 jobs over 30 days on 104 x 96 nodes)
   through ``TraceSimulator`` -- every job started, ``BENCH_sim.json``'s
   series length and mean allocation (an exactly rounded sum: ``np.mean``
   moves by an ulp between numpy builds), a pinned digest; its fast-versus-legacy
   parity trace (both equal to ``BENCH_sim.json``'s checksum);
   ``bench_faults``'s fault month (a 4096-node LPJ under seeded faults)
   under the elastic repair ladder, twice, and with no repair -- the fault
   trace's digest and the elastic digest equal to ``BENCH_faults.json``'s,
   the never-repair digest pinned, elastic goodput above never-repair's;
   every LPJ plan and re-plan checked to come from a solve that no time
   limit cut; and the modelled tokens/s and step-time breakdown of
   ``placement``'s 9600-GPU job under each policy (the network model of the
   paper's cluster, not a measurement of the card).
7. ``serve``   -- glm4-9b at full width and full depth (40 layers, bf16, random
   weights from a seed) serving 16 seeded requests through ``ServeEngine``;
   checks every result, the page allocator and the kernels' launch counts.
8. ``zamba_parity`` -- zamba2-2.7b at full width, 12 layers: a 300-token
   forward through the kernels against the plain versions in fp32 and bf16
   (weights and tokens from four seeds), and the fp32 teacher-forced decode
   against the forward (first seed).
9. ``zamba``   -- zamba2-2.7b at full width and full depth (54 layers, bf16,
   random weights from a seed): one 32768-token forward, then 128 decode
   steps at batch 8; checks the outputs and the exact launch counts.
10. ``train_parity`` -- minicpm-2b at full width, 4 layers, fp32 masters: the
   loss and every parameter's gradient on one batch of 4 x 1024 tokens
   through the kernels (forward and backward) against autograd through the
   plain versions, in fp32 and in bf16 compute (rule in the phase).
11. ``train``   -- minicpm-2b at full width and full depth (40 layers) with the
   reference's defaults (bf16 compute, fp32 masters and AdamW state, remat):
   8 steps of ``make_train_step`` on ``SyntheticDataset`` batches under a WSD
   schedule; checks finite, falling loss, every gradient present and finite,
   the exact launches of each step; reports step time, tokens/s, TFLOP/s and
   peak memory.
12. ``trainer`` -- the reduced config on the card through
   ``repro_torch.launch.train.main``, and a ``Trainer`` restarted by a
   ``FaultInjector`` against an uninterrupted one (final checkpoints
   bit-identical); then reduced zamba2-2.7b, qwen3-moe-235b-a22b and
   phi-3-vision-4.2b through the launcher, each once with a step failing and
   restored, once uninterrupted (bit-identical: the MoE's dispatch and
   combine sum in a fixed order).
13. ``zamba_train_parity`` -- ``train_parity`` for zamba2-2.7b at full width,
   12 layers (two units), fp32 masters, fp32 and bf16 compute.
14. ``zamba_train`` -- zamba2-2.7b at full width and depth (54 Mamba2 layers,
   the shared block applied 9 times), bf16 compute on fp32 masters, remat of
   each Mamba2 layer: 8 steps of ``make_train_step`` under its cosine schedule,
   with ``train``'s checks and reports.
15. ``moe_parity`` -- qwen3-moe-235b-a22b (128 experts, top-8) at full width,
   2 layers: ``parity``, the plain run held to the kernel run's routes; fp32
   routes identical, in bf16 the share the plain run would flip reported
   (rule in the phase).
16. ``moe_serve`` -- qwen3-moe at full width and 12 of its 94 layers (62 GB of
   bf16 weights: one card's cut) through ``serve``'s engine, requests and
   checks.
17. ``moe_train_parity`` -- ``train_parity`` for qwen3-moe at 1 layer, the
   plain run held to the kernel run's routes (rule in the phase).
18. ``moe_train`` -- qwen3-moe at full width and 1 layer (59.7 GB of fp32
   weights, gradients and AdamW moments): ``train``'s 8 steps, checks and
   reports, a finite aux loss at every step, model FLOPs over the active
   (top-8) experts.
19. ``vlm_train_parity`` -- ``train_parity`` for phi-3-vision-4.2b at full
   width, 4 layers, with 576 patch embeddings from a seed before the 1024
   tokens (flash attention at head dim 96 over 1600 positions).
20. ``vlm_train`` -- phi-3-vision at full width and depth (32 layers): 8
   steps of ``train`` with its patches.
21. ``xlstm_parity`` -- xlstm-350m at full width, 4 layers (one unit: 3
   mLSTM + 1 sLSTM): a 256-token forward at batch 2 through the kernels
   against the plain versions in fp32 and bf16, and 16 teacher-forced decode
   steps against the forward.
22. ``xlstm`` -- xlstm-350m at full width and depth (24 layers, bf16, random
   weights from a seed): a 1024-token forward at batch 1, then 128 decode
   steps at batch 8; exact launch counts.  Its recurrences are plain tensor
   code a step at a time (the reference's ``lax.scan``), host-bound.
23. ``xlstm_train_parity`` -- ``train_parity`` for xlstm-350m at 4 layers.
24. ``xlstm_train`` -- xlstm-350m at full width and depth: 3 steps of 4 x
   256 tokens (its sequence cut from 4096, printed on a NOTE line), remat of
   each unit and every 128 recurrence steps; the loss must fall on each
   step's own batch.
25. ``whisper_parity`` -- whisper-tiny at full width and depth (4 + 4
   layers): a forward over 1500 frames and 448 tokens at batch 2, kernels
   against plain in fp32 and bf16, then ``prefill_cross`` and 16
   teacher-forced decode steps against the forward; again with 24 frames.
26. ``whisper`` -- whisper-tiny served (bf16): ``prefill_cross`` of 8 lanes of
   1500 frames, then 128 decode steps; exact launch counts.
27. ``whisper_train_parity`` -- ``train_parity`` for whisper-tiny at full depth.
28. ``whisper_train`` -- whisper-tiny trained: 8 steps of 4 x (1500 frames +
   448 tokens), remat of each layer.
29. ``save_tp`` (after ``train``) -- ``train``'s minicpm-2b recipe, 3 steps
   under ``remat_policy="save_tp_outputs"`` and 3 under ``"full"`` from the same
   init: equal losses, the exact launches of every step, peak memory and step
   ms of both.
30. ``roofline`` (after ``whisper_train``) -- the port's ``Roofline`` on H100
   constants (``launch/roofline.py``) for ``train``'s step, glm4-9b's
   1024-token prefill and 8-lane decode (timed after ``serve``) and
   ``zamba``'s 32k forward: FLOPs from ``FlopCounterMode`` on meta tensors,
   bytes from ``analytic_hbm_bytes``; measured ms against ``bound_s``.
31. ``dryrun`` -- ``python -m repro_torch.launch.dryrun`` on the card machine's
   host for whisper-tiny x decode_32k, minicpm-2b x train_4k and
   qwen3-moe-235b-a22b x decode_32k on the single-pod mesh (256 fake ranks,
   meta tensors), three processes started before ``roofline`` and collected
   here: status, chips, peak bytes per device (the dry run's own account of
   the step's storages) at or above the arguments and within a closed-form
   reckoning printed beside it, roofline terms; and one cell the card runs
   for real beside its trace (minicpm-2b at full width, 4 layers, 2 x 4096
   tokens, the meshed step on a world of one, the kernels' calls taking the
   plain route the trace takes): the counted peak within 3 % of
   ``max_memory_allocated``.
32. ``dbrx_parity`` (after ``moe_train``) -- ``moe_parity`` for dbrx-132b (16
   experts of 10752, top-4, GQA 48:8) at full width, 2 layers.
33. ``dbrx_serve`` -- dbrx-132b at full width and 9 of its 40 layers (61.1 GB
   of bf16 weights: one card's cut; its training waits for more than one
   card) through ``serve``'s engine, requests and checks.
34. ``phi4_serve`` -- phi4-mini-3.8b (GQA 24:8, an untied 200 192-column head)
   at full width and depth (32 layers) through ``serve``.
35. ``phi4_train_parity`` -- ``train_parity`` for phi4-mini-3.8b at 4 layers
   (flash forward with lse and backward at the GQA group of 3).
36. ``phi4_train`` -- phi4-mini-3.8b at full width and depth (32 layers; 71.2
   GB of fp32 weights, gradients and AdamW moments): ``train``'s 8 steps,
   checks and reports.
37. ``granite_serve`` -- granite-8b (GQA 32:8, rope_theta 1e7) at full width
   and depth (36 layers) through ``serve``.
38. ``examples`` (before ``roofline``) -- the four ``repro_torch.examples``
   (quickstart, serve, schedule_and_launch on a world of one, elastic_failover)
   on the card through their ``main()``: their asserts, their closing ``OK``,
   their scheduling output and launches.

The parallelism layer (``repro_torch.parallel``, the meshed steps of
``train/train_step.py``) runs in three phases.  One card holds one rank (NCCL
refuses two ranks on one device), so on the card it runs as a world of one
-- NCCL, the DTensor path and the kernels on local shards at full width --
and its multi-rank logic on the host:

- ``mesh_host`` (after ``simulate``) -- the CPU tests' 4-rank gloo world
  (``tests/torch_parallel_world.py``, the reduced models' weights made by the
  port from a seed) on this machine's torch: the meshed train step on a (2, 2)
  mesh for a dense, a MoE and a hybrid model against the unmeshed step, the
  seq-sharded decode, zamba2's, the xLSTM's and Whisper's meshed decodes, the
  pipeline, the compressed mean.
- ``mesh_serve`` (after ``serve``) -- glm4-9b at full width and the serve
  phase's depth: 16 greedy dense decode steps at 8 lanes through
  ``make_serve_step`` with ``cache_shardings`` on a world of one against the
  unmeshed ``decode_step``: the same tokens, the logits within ``parity``'s
  bf16 rule, the same launches; ``mesh_serve_zamba`` (after ``zamba``) and
  ``mesh_serve_xlstm`` (after ``xlstm``) the same for zamba2-2.7b and
  xlstm-350m at full width and depth (their ring caches and recurrent states
  written back through each rank's shard).
- ``mesh_train`` (after ``trainer``) -- minicpm-2b at full width and depth,
  ``train``'s recipe: 3 steps of the meshed ``make_train_step`` on a world of
  one, then 3 unmeshed from the same init; the losses within 1e-4, every leaf
  a whole local shard on the card, the exact launches of ``train``; one more
  step of each under torch.profiler (the DTensor overhead on a world of one);
  then the reduced config through the launcher, ``--devices 1 --mesh-shape
  1x1`` (rc 0: a falling loss).

With ``--cards 4`` (four cards of one host) only ``env``, ``build`` and
``mesh_cards`` run: ``mesh_host``'s world on NCCL, rank r on ``cuda:r``, the
kernels on the local shards, held to ``mesh_host``'s rules and with the
meshed train step's launches equal to the unmeshed step's and each layer's
ZeRO-3 leaves gathered twice in a remat step; then ``mesh_cards_dbrx``:
dbrx-132b at its published widths through the meshed steps in one NCCL world
-- 32 greedy decode steps at 8 lanes of all 40 layers in bf16 on a (1, 4) mesh
(EP and TP 4) and on (2, 2) (TP/EP 2, ZeRO-3 2, each layer's weights gathered
at its use), both meshes at 4 layers against one card's decode, 4 train steps
at 5 of 40 layers on (2, 2) (the launcher's recipe) against the dry run's
count of the cell (peak + 5 %, NCCL bytes to the byte) and an unmeshed bf16
forward; then the launcher with ``--devices 4 --mesh-shape 2x2 --arnold
--scheduler mip`` (rc 0); then ``mesh_cards_glm4``: glm4-9b at full width and
depth trained through the launcher (``--full --devices 4 --mesh-shape 2x2
--arnold``, 8 steps of 8 x 1024 tokens at peak lr TRAIN_LR, a checkpoint at
step 8, then ``--steps 9`` restoring it; 112.8 GB of fp32 state, a
checkpoint as large: it needs room for two in ``/dev/shm`` or on the
temporary directory's file system or the checkout's, and rank 0 holds one
on the host while it saves), each rank's peak before its first step and
over the steps, its launches a step, step 1's loss against an unmeshed bf16
forward on one card, and steps of its own world measured on rank 0 (NCCL's
device ms and bytes by kind under torch.profiler, the host's time in the
ZeRO-3 gathers) beside Eq. 1's volumes and the dry run's count of the cell;
no ``kernels`` line.

With ``--profile`` further phases, after ``serve``, ``zamba``,
``train_parity``, ``train``, ``zamba_train``, ``moe_serve``, ``moe_train``,
``vlm_train``, ``xlstm``, ``xlstm_train``, ``whisper`` and ``whisper_train``,
trace a decode step and a prefill (a forward, Whisper's ``prefill_cross``) of
each served model, one
fp32-compute ``loss_and_grads`` of ``train_parity``'s model (the launcher's
dtype) and one train step of each trained model with ``torch.profiler``
(device-busy time against the host's wall clock, and the flash and SSD
kernels' shares, the SSD backward's kernels apart, the MoE's routing,
dispatch, expert GEMMs and combine apart).

Then the ``kernels`` summary line (the three forwards and the three
backwards: launches over every main path -- serve, zamba, train,
zamba_train, moe_serve, moe_train, vlm_train, xlstm, xlstm_train, whisper,
whisper_train, mesh_train, mesh_serve, mesh_serve_zamba, mesh_serve_xlstm,
save_tp, dbrx_serve, phi4_serve, phi4_train, granite_serve, examples -- error,
times and roofline
bound per kernel), the host's CPU model, the card as ``nvidia-smi`` names it,
and the verdict as the last line.  There is no CPU path: without a CUDA device the
script exits non-zero before printing anything.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention.bias import causal_lower_right

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import repro_torch.core as core  # noqa: E402
import repro_torch.faults as faults  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Cluster,
    JobSpec,
    ModelSpec,
    ScheduleRequest,
    build_comm_matrix,
    get_scheduler,
    throughput_of_placement,
    weighted_spread,
)
from repro_torch.data import Prefetcher, SyntheticDataset  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as _fa  # noqa: E402
from repro_torch.kernels import rmsnorm as _rms  # noqa: E402
from repro_torch.kernels import ssd_chunk as _ssd  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.convert import to_jax_layout  # noqa: E402
from repro_torch.launch.mesh import arnold_rank_grid, grid_group_spread, process_group  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.whisper import N_FRAMES  # noqa: E402
from repro_torch.optim import AdamWConfig, get_schedule, init_opt_state  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    EngineConfig,
    LengthMixture,
    LoadGenConfig,
    ReplicaSpec,
    ServeEngine,
    ServeReport,
    generate_requests,
    place_replicas,
)
from repro_torch.serve.placement import serving_model_spec  # noqa: E402
from repro_torch.train import (  # noqa: E402
    FaultInjector,
    Trainer,
    TrainerConfig,
    loss_and_grads,
    make_train_step,
)
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.pipeline import pp_boundary_bytes  # noqa: E402
from repro_torch.train.train_step import batch_to_device, make_serve_step  # noqa: E402

# Published peaks of one H100 SXM (dense, no sparsity; launch/roofline.py,
# from NVIDIA's datasheet); bounds are stated against these whatever the
# card's power limit, which is printed beside them.
HBM_BYTES_PER_S = rf.HBM_BW
PEAK_FLOPS = {torch.bfloat16: rf.PEAK_FLOPS, torch.float32: rf.PEAK_FLOPS_FP32}
L2_BYTES = 50 * 2**20

# |kernel - plain| <= TOL + TOL * |plain| elementwise (the reference's own test
# rule, rtol = atol): bf16 results differ by one rounding of the output, which
# grows with the value (2e-2); fp32 differs by the order of the sums (1e-4).
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The SSD scan's final state (fp32) against its plain version: rtol = atol =
# 1e-4, the reference's own test rule for S_final.
SSD_STATE_TOL = 1e-4

# zamba2-2.7b's prefill: the sequence of the reference's prefill_32k shape
# (its batch of 32 cut to 1), and a shorter shared-attention case kept as the
# timing yardstick of earlier runs.
ZAMBA_SEQ = 32768
ZAMBA_ATTN_SEQ = 4096

# xlstm-350m: its serving forward's tokens (batch 1: eight 128-step segments)
# and its training step's 4 x 256 tokens (two segments).  Its recurrences run a
# step at a time on the host (the reference's lax.scan; no kernel), so the
# host's time grows with the sequence: training is cut from train_4k's 4096
# tokens a sequence, widths and depth unchanged.  The parity phases hold one
# unit (3 mLSTM + 1 sLSTM).
XLSTM_SEQ = 1024
XLSTM_TRAIN_SEQ = 256
XLSTM_TRAIN_STEPS = 3
XLSTM_PARITY_LAYERS = 4
# whisper-tiny: the decoder's context (the encoder takes N_FRAMES = 1500)
WHISPER_SEQ = 448


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Max abs error of ``got`` against ``want``; raises if shape, dtype or any
    element is outside the tolerance for ``want``'s dtype."""
    tol = TOL[want.dtype]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    within = bool((diff <= tol + tol * want.float().abs()).all().item())
    if got.shape != want.shape or got.dtype != want.dtype or not math.isfinite(err) or not within:
        raise AssertionError(f"{what}: kernel disagrees with its plain version, max abs err "
                             f"{err} (rtol = atol = {tol})")
    return err


#: every phase's line as emitted, by phase (the roofline phase reads the times)
REPORTS: dict[str, dict] = {}


def emit(obj: dict) -> None:
    if "phase" in obj:
        REPORTS[obj["phase"]] = obj
    print(json.dumps(obj), flush=True)


def _elapsed_ms(run) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def time_ms(fn, arg_sets: list[tuple], iters: int) -> tuple[float, float]:
    """Mean milliseconds per call of ``fn``, by CUDA events after warm-up:
    (device, eager).  ``device`` replays a CUDA graph holding ``iters`` calls,
    so it is the time on the card without the host's launch gaps; ``eager``
    is the same loop issued call by call, which is the host's cost per call
    wherever the device work is shorter than that.  The calls cycle through
    ``arg_sets`` (sized past the L2 cache where the caller would find the
    inputs cold)."""
    def loop():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    eager = _elapsed_ms(loop) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop()
    graph.replay()
    torch.cuda.synchronize()
    device = _elapsed_ms(graph.replay) / iters
    del graph
    return device, eager


def timings(case: dict, **fns_and_args) -> None:
    """Fill ``<name>_ms`` (device) and ``<name>_eager_ms`` for each entry."""
    for name, spec in fns_and_args.items():
        if spec is None:
            case[f"{name}_ms"] = case[f"{name}_eager_ms"] = None
        else:
            case[f"{name}_ms"], case[f"{name}_eager_ms"] = time_ms(*spec)


def ptxas_report(outputs: dict[str, str]) -> list[dict]:
    """Registers, spill bytes and static shared memory of every kernel, read
    from ``nvcc -Xptxas -v``; template arguments shown as in the mangled name
    (numbers, ``bf16``, ``f32``)."""
    rows = []
    for stem, text in outputs.items():
        for entry in text.split("Compiling entry function '")[1:]:
            mangled = entry.split("'", 1)[0]
            m = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", mangled)
            args = ""
            if m:
                args = re.sub(r"Li(\d+)E", r"\1,", m.group(2))
                args = args.replace("Lb0E", "false,").replace("Lb1E", "true,")
                args = args.replace("13__nv_bfloat16", "bf16,").replace("S1_", "bf16,")
                args = re.sub(r"(?<![\w])f(?=\d|,|$)", "f32,", args).rstrip(",")
            used = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
            smem = re.search(r"(\d+) bytes smem", entry)
            rows.append({
                "source": stem, "kernel": f"{m.group(1)}<{args}>" if m else mangled,
                "registers": int(used.group(1)) if used else None,
                "spill_store_bytes": int(spill.group(1)) if spill else None,
                "spill_load_bytes": int(spill.group(2)) if spill else None,
                "static_smem_bytes": int(smem.group(1)) if smem else 0,
            })
    return rows


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------------ kernels
def rmsnorm_case(shape: tuple[int, ...], dtype: torch.dtype, gen: torch.Generator,
                 iters: int) -> dict:
    dev = gen.device
    d = shape[-1]
    rows = math.prod(shape[:-1])
    nbytes = 2 * rows * d * dtype.itemsize + d * 4
    n_sets = max(1, min(8, -(-2 * L2_BYTES // nbytes)))
    sets = [(torch.randn(shape, device=dev, dtype=torch.float32, generator=gen).to(dtype),
             1.0 + 0.1 * torch.randn(d, device=dev, dtype=torch.float32, generator=gen))
            for _ in range(n_sets)]
    x, scale = sets[0]
    got = ops.rmsnorm(x, scale, 1e-5)
    torch.cuda.synchronize()
    want = ref.rmsnorm_ref(x, scale, 1e-5)
    err = compare(got, want, f"rmsnorm {shape} {dtype}")
    # bf16 rows of a width divisible by 8 (16-byte vectors) are held in
    # registers when there are enough to fill the card (the scale here is
    # fp32, as the models'); all else (fp32, ragged widths, decode's few rows)
    # takes the block-per-row kernel
    route = _rms.rmsnorm_plan(x, scale, got).route
    many_rows = rows >= _rms.N_SM
    if route != ("registers" if dtype == torch.bfloat16 and d % 8 == 0 and many_rows else "block"):
        raise AssertionError(f"rmsnorm {shape} {dtype} took the {route!r} route")
    case = {
        "kernel": "rmsnorm", "shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
        "route": route, "max_abs_err": err, "tol": TOL[dtype],
    }
    timings(
        case,
        kernel=(lambda a, s: ops.rmsnorm(a, s, 1e-5), sets, iters),
        plain=(lambda a, s: ref.rmsnorm_ref(a, s, 1e-5), sets, iters),
        library=(lambda a, s: F.rms_norm(a, (d,), s, 1e-5),
                 [(a, s.to(dtype)) for a, s in sets], iters),
    )
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * rows * d / PEAK_FLOPS[torch.float32] * 1e3   # fp32 on the CUDA cores
    case["bound_ms"] = max(by_bytes, by_ops)
    case["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return case


def flash_ref_by_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """The plain version one query head at a time: at 32k tokens its fp32
    scores take 4.3 GB per head, 137 GB for all 32 at once."""
    group = q.shape[1] // k.shape[1]
    return torch.cat([ref.flash_attention_ref(q[:, h: h + 1], k[:, h // group: h // group + 1],
                                              v[:, h // group: h // group + 1], causal=causal)
                      for h in range(q.shape[1])], dim=1)


def flash_case(b: int, hq: int, hkv: int, sq: int, skv: int, hd: int, dtype: torch.dtype,
               gen: torch.Generator, iters: int, model_layout: bool, offset: int = 0,
               causal: bool = True, q_scale: float = 1.0, by_head: bool = False,
               with_lse: bool = False) -> dict:
    """``model_layout``: tensors held as (b, s, h, hd) and passed as transposed
    views, as the model does.  ``offset``: elements by which each tensor's
    storage is shifted (1 breaks the 16-byte alignment of bf16 rows).
    ``q_scale`` > 1 sharpens the softmax, so that each output row is led by a
    few keys and a key tile missed anywhere in a long row shows in the result
    (with unit scores a row of 32k keys averages v towards 0, inside the
    absolute tolerance).  ``by_head``: the plain version runs head by head.
    ``with_lse``: the kernel also writes lse, as the training forward does,
    held against the plain version's and timed with it."""
    dev = gen.device

    def rand(h: int, s: int, scale: float = 1.0) -> torch.Tensor:
        shape = (b, s, h, hd) if model_layout else (b, h, s, hd)
        flat = (torch.randn(math.prod(shape) + offset, device=dev, dtype=torch.float32,
                            generator=gen) * scale).to(dtype)
        t = flat[offset:].view(shape)
        return t.transpose(1, 2) if model_layout else t   # logical (b, h, s, hd)

    plain = flash_ref_by_head if by_head else ref.flash_attention_ref
    q, k, v = rand(hq, sq, q_scale), rand(hkv, skv), rand(hkv, skv)
    what = f"flash_attention q{tuple(q.shape)} kv{tuple(k.shape)} {dtype}"
    lse_err = res_reading = None
    if with_lse:
        got, lse, got_res = _fa.flash_attention_cuda(q, k, v, causal, with_lse=True)
        torch.cuda.synchronize()
        want, want_lse = ref.flash_attention_lse_ref(q, k, v, causal)
        lse_err = compare(lse, want_lse, f"{what} lse")
        if got_res is not None:
            # a reading: out and out + out_res (what the backward's D takes)
            # against the plain version's unrounded out
            want32, _ = ref.flash_attention_lse_ref(q.float(), k.float(), v.float(), causal)
            res_reading = {"out": (got.float() - want32).abs().max().item(),
                           "out_plus_res": (got.float() + got_res.float() - want32).abs().max().item()}
            del want32
        del lse, want_lse, got_res
    else:
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = plain(q, k, v, causal=causal)
    err = compare(got, want, what)
    # aligned bf16 runs on wgmma/TMA, fp32 and offset bf16 on the CUDA cores
    plan = _fa.flash_plan(q, k, v, got)
    if plan.route != ("wgmma" if dtype == torch.bfloat16 and offset == 0 else "cuda_cores"):
        raise AssertionError(f"flash_attention q{tuple(q.shape)} {dtype} offset {offset} took "
                             f"the {plan.route!r} route")
    args = [(q, k, v)]
    case = {
        "kernel": "flash_attention", "q": list(q.shape), "kv": list(k.shape),
        "layout": "(b,s,h,hd) strided" if model_layout else "(b,h,s,hd) contiguous",
        "route": plan.route, "block_q": plan.bm, "block_kv": plan.bn, "stages": plan.stages,
        "vector_loads": plan.vector_loads, "smem_bytes": plan.smem_bytes, "with_lse": with_lse,
        "lse_max_abs_err": lse_err, "max_abs_err_vs_unrounded_plain": res_reading,
        "rows_16_byte_aligned": q.data_ptr() % 16 == 0, "causal": causal, "q_scale": q_scale,
        "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err, "tol": TOL[dtype],
        "max_abs_plain": want.abs().max().item(),
        "mean_abs_plain_last_row": want[:, :, -1].float().abs().mean().item(),
    }
    del got, want
    kernel = ((lambda *a: _fa.flash_attention_cuda(*a, causal, with_lse=True)) if with_lse
              else (lambda *a: ops.flash_attention(*a, causal=causal)))
    timings(
        case,
        kernel=(kernel, args, iters),
        plain=((lambda *a: ref.flash_attention_lse_ref(*a, causal)) if with_lse
               else (lambda *a: plain(*a, causal=causal)), args, 1 if by_head else iters),
        library=(library_attention(sq, skv, causal, hq // hkv), args, iters),
    )
    # work this call needs: causal row i of q sees keys 0 .. i + (skv - sq)
    visible = sum(min(skv, i + skv - sq + 1) for i in range(sq)) if causal else sq * skv
    flops = 4 * b * hq * visible * hd
    # q, k, v read, out written (and, for bf16 with lse, out_res; lse is small)
    nbytes = (2 * q.numel() + k.numel() + v.numel()
              + (q.numel() if with_lse and dtype != torch.float32 else 0)) * dtype.itemsize
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    case["bound_ms"] = max(by_bytes, by_ops)
    case["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    case["kernel_tflops"] = flops / case["kernel_ms"] / 1e9
    return case


def timed_grad_ms(forward, inputs: list[torch.Tensor], dout: torch.Tensor, iters: int) -> float:
    """Device milliseconds of one backward of ``forward`` under autograd, the
    forward outside the timed region: a CUDA graph of ``iters`` forwards and
    backwards less one of ``iters`` forwards (the library yardsticks)."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]

    def fwd():
        return forward(*leaves)

    def both():
        torch.autograd.grad(forward(*leaves), leaves, dout)

    side = torch.cuda.Stream()   # warm-up on a side stream before capturing autograd
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            both()
    torch.cuda.current_stream().wait_stream(side)
    times = {}
    for name, fn in (("fwd", fwd), ("both", both)):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times[name] = _elapsed_ms(graph.replay) / iters
        del graph
    return times["both"] - times["fwd"]


def library_attention(sq: int, skv: int, causal: bool, group: int):
    """SDPA as one PyTorch call computing the kernels' function (a yardstick
    the port never calls).  Its ``is_causal`` mask is aligned top-left, the
    kernels' bottom-right, so where ``sq != skv`` it takes
    ``causal_lower_right(sq, skv)``, with K and V repeated to the q heads
    inside the call (the bias does not take ``enable_gqa``)."""
    if not causal or sq == skv:
        return lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                              enable_gqa=True)
    bias = causal_lower_right(sq, skv)
    return lambda q, k, v: F.scaled_dot_product_attention(
        q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1), attn_mask=bias)


def flash_bwd_case(b: int, hq: int, hkv: int, sq: int, skv: int, hd: int, dtype: torch.dtype,
                   gen: torch.Generator, iters: int, model_layout: bool,
                   causal: bool = True, offset: int = 0) -> dict:
    """The backward kernel on the forward kernel's out and lse, against the
    plain backward (``ref.flash_attention_bwd_ref``) on the same inputs;
    ``model_layout``: q, k, v and dout held as (b, s, h, hd) and passed as
    transposed views, as autograd hands them over; ``offset``: elements by
    which each input's storage is shifted (1 breaks bf16 rows' alignment)."""
    dev = gen.device

    def rand(h: int, s: int) -> torch.Tensor:
        shape = (b, s, h, hd) if model_layout else (b, h, s, hd)
        flat = torch.randn(math.prod(shape) + offset, device=dev, dtype=torch.float32,
                           generator=gen).to(dtype)
        t = flat[offset:].view(shape)
        return t.transpose(1, 2) if model_layout else t

    q, k, v, dout = rand(hq, sq), rand(hkv, skv), rand(hkv, skv), rand(hq, sq)
    out, lse, out_res = _fa.flash_attention_cuda(q, k, v, causal, with_lse=True)
    got = _fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, out_res)
    again = _fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, out_res)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal, out_res)
    what = f"flash_attention_bwd q{tuple(q.shape)} kv{tuple(k.shape)} {dtype}"
    errs = {name: compare(g, w, f"{what} {name}") for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    # no atomics and a fixed order for every sum: two calls agree bit for bit
    for name, a, b2 in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b2):
            raise AssertionError(f"{what} {name}: two calls on the same inputs differ")
    # aligned bf16 runs on wgmma/TMA, fp32 and offset bf16 on the CUDA cores
    plan = _fa.flash_bwd_plan(q, k, v, out, dout, *got)
    if plan.route != ("wgmma" if dtype == torch.bfloat16 and offset == 0 else "cuda_cores"):
        raise AssertionError(f"{what} offset {offset} took the {plan.route!r} route")
    if plan.dot_blocks != 0:   # both routes compute D in the dQ kernel
        raise AssertionError(f"{what}: the plan launches a D pass ({plan.dot_blocks} blocks)")
    case = {
        "kernel": "flash_attention_bwd", "q": list(q.shape), "kv": list(k.shape),
        "layout": "(b,s,h,hd) strided" if model_layout else "(b,h,s,hd) contiguous",
        "route": plan.route, "block_rows": plan.rows, "block_cols": plan.cols,
        "block_cols_dq": plan.cols_dq, "stages": plan.stages, "splits": plan.splits,
        "vector_loads": plan.vector_loads, "d_pass_blocks": plan.dot_blocks,
        "workspace_bytes": plan.workspace_bytes, "grid_dkv": list(plan.grid_dkv),
        "smem_bytes": plan.smem_bytes, "smem_dq_bytes": plan.smem_dq_bytes, "causal": causal,
        "dtype": str(dtype).removeprefix("torch."), "bit_identical_twice": True,
        "max_abs_err": max(errs.values()), "max_abs_err_each": errs, "tol": TOL[dtype],
        "max_abs_plain": max(w.float().abs().max().item() for w in want),
    }
    del got, again, want
    args = [(q, k, v, out, lse, dout)]
    timings(
        case,
        kernel=(lambda *a: _fa.flash_attention_bwd_cuda(*a, causal, out_res), args, iters),
        plain=(lambda *a: ref.flash_attention_bwd_ref(*a, causal, out_res), args,
               max(1, iters // 4)),
        library=None,
    )
    # its backward faults on inputs shifted off 16 bytes, so it gets aligned
    # copies of the same values
    case["library_ms"] = timed_grad_ms(library_attention(sq, skv, causal, hq // hkv),
                                       [t.clone() for t in (q, k, v)], dout.clone(), iters)
    visible = sum(min(skv, i + skv - sq + 1) for i in range(sq)) if causal else sq * skv
    # five products of 2 hd flops per visible pair: S (recomputed), dP, dV, dQ, dK
    flops = 10 * b * hq * visible * hd
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + out.numel() + dout.numel()
              + (0 if out_res is None else out_res.numel())) * dtype.itemsize + lse.numel() * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    case["bound_ms"] = max(by_bytes, by_ops)
    case["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    case["kernel_tflops"] = flops / case["kernel_ms"] / 1e9
    return case


def flash_lse_case(b: int, hq: int, hkv: int, s: int, hd: int, dtype: torch.dtype,
                   gen: torch.Generator, skv: int | None = None, causal: bool = True) -> dict:
    """The forward's out is bit-identical with and without lse, and lse
    agrees with the plain version's (fp32 rule); model layout; ``skv`` keys
    (default ``s``)."""
    q, k, v = (torch.randn((b, n, h, hd), device=gen.device, generator=gen).to(dtype).transpose(1, 2)
               for h, n in ((hq, s), (hkv, skv or s), (hkv, skv or s)))
    alone = _fa.flash_attention_cuda(q, k, v, causal)
    out, lse, _ = _fa.flash_attention_cuda(q, k, v, causal, with_lse=True)
    torch.cuda.synchronize()
    if not torch.equal(alone, out):
        raise AssertionError(f"flash forward q{tuple(q.shape)} {dtype}: storing lse changed out")
    _, want = ref.flash_attention_lse_ref(q, k, v, causal)
    return {"kernel": "flash_attention", "case": "lse", "q": list(q.shape), "kv": list(k.shape),
            "causal": causal, "dtype": str(dtype).removeprefix("torch."),
            "route": _fa.flash_plan(q, k, v, out).route,
            "out_bit_identical_with_lse": True, "lse_max_abs_err": compare(lse, want, "lse"),
            "tol": TOL[torch.float32]}


def rmsnorm_bwd_pass_ms(fn, iters: int) -> dict:
    """Device milliseconds of the RMSNorm backward's two kernels apart: the
    row pass (``rmsnorm_bwd_warp_kernel`` or ``rmsnorm_bwd_kernel``: dx and
    each block's partial dscale row) and the dscale pass
    (``rmsnorm_dscale_kernel``), the mean of torch.profiler's kernel records
    over ``iters`` calls of ``fn`` after a warm-up call (the profiler may drop
    some records; their counts are reported)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {"row_pass": [0.0, 0], "dscale_pass": [0.0, 0]}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "device_time", None)
            us = evt.cuda_time if us is None else us
            key = "dscale_pass" if "rmsnorm_dscale_kernel" in evt.name else \
                "row_pass" if "rmsnorm_bwd" in evt.name else None
            if key:
                ms[key][0] += us / 1e3
                ms[key][1] += 1
    if any(n == 0 or n > iters for _, n in ms.values()):
        raise AssertionError(f"the profiler saw {ms} RMSNorm backward kernels in {iters} calls")
    return {**{f"{key}_ms": total / n for key, (total, n) in ms.items()},
            "pass_records": {key: n for key, (_, n) in ms.items()}}


def rmsnorm_bwd_case(shape: tuple[int, ...], dtype: torch.dtype, gen: torch.Generator,
                     iters: int) -> dict:
    dev = gen.device
    d = shape[-1]
    rows = math.prod(shape[:-1])
    x, dy = (torch.randn(shape, device=dev, generator=gen).to(dtype) for _ in range(2))
    scale = 1.0 + 0.1 * torch.randn(d, device=dev, generator=gen)
    dx, dscale = _rms.rmsnorm_bwd_cuda(x, scale, dy, 1e-5)
    again = _rms.rmsnorm_bwd_cuda(x, scale, dy, 1e-5)
    torch.cuda.synchronize()
    want_dx, want_dscale = ref.rmsnorm_bwd_ref(x, scale, dy, 1e-5)
    what = f"rmsnorm_bwd {shape} {dtype}"
    err = compare(dx, want_dx, f"{what} dx")
    err_scale = compare(dscale, want_dscale, f"{what} dscale")
    # no atomics and a fixed order for every sum: two calls agree bit for bit
    for name, a, b in zip(("dx", "dscale"), (dx, dscale), again):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} {name}: two calls on the same inputs differ")
    plan = _rms.rmsnorm_bwd_plan(x, scale, dx)
    if plan.route != _rms.rmsnorm_plan(x, scale, dx).route:
        raise AssertionError(f"{what}: the backward took {plan.route!r}, not the forward's route")
    # a lane's partials stay in registers up to REGISTER_PARTIALS_VPL vectors
    shared = plan.route == "registers" and plan.vectors_per_lane > _rms.REGISTER_PARTIALS_VPL
    if plan.partials != ("shared" if shared else "registers"):
        raise AssertionError(f"{what}: partials in {plan.partials!r} at {plan.vectors_per_lane} vectors")
    case = {"kernel": "rmsnorm_bwd", "shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "route": plan.route, "vectors_per_lane": plan.vectors_per_lane, "blocks": plan.blocks,
            "threads": plan.threads, "units": plan.units, "vector_loads": plan.vector_loads,
            "partials": plan.partials, "smem_bytes": plan.smem_bytes, "bit_identical_twice": True,
            "max_abs_err": err, "dscale_max_abs_err": err_scale, "tol": TOL[dtype],
            "dscale_tol": TOL[torch.float32]}
    del dx, dscale, again, want_dx, want_dscale
    args = [(x, scale, dy)]
    timings(
        case,
        kernel=(lambda *a: _rms.rmsnorm_bwd_cuda(*a, 1e-5), args, iters),
        plain=(lambda *a: ref.rmsnorm_bwd_ref(*a, 1e-5), args, iters),
        library=None,
    )
    case.update(rmsnorm_bwd_pass_ms(lambda: _rms.rmsnorm_bwd_cuda(x, scale, dy, 1e-5), iters))
    case["library_ms"] = timed_grad_ms(lambda a, s: F.rms_norm(a, (d,), s.to(dtype), 1e-5),
                                       [x, scale], dy, iters)
    # x and dy read, dx written, scale read and dscale written once
    nbytes = 3 * rows * d * dtype.itemsize + 2 * d * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 10 * rows * d / PEAK_FLOPS[torch.float32] * 1e3   # fp32 on the CUDA cores
    case["bound_ms"] = max(by_bytes, by_ops)
    case["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return case


# what an SSD case's plan must choose for the sequence segments G
SEGMENTS = {
    "one": lambda g, n: g == 1,              # b * H alone fills the card, or one chunk
    "many": lambda g, n: g > 1,              # the card filled by segments
    "ragged": lambda g, n: n % g != 0,       # segments of unequal length
    "any": lambda g, n: 1 <= g <= n,
}


def ssd_case(b: int, H: int, s: int, P: int, N: int, chunk: int, dtype: torch.dtype,
             gen: torch.Generator, iters: int, model_layout: bool,
             out_dtype: torch.dtype | None = None, vs_fp32_cumsum: bool = False,
             segments: str = "one") -> dict:
    """``model_layout``: x held as (b, s, H, P) and passed as a transposed view,
    B/C as (b, s, N) shared by the heads and passed as head-stride-0 views,
    dt/loga as (b, s, H), as ``mamba2_fwd`` does.  ``vs_fp32_cumsum``: also
    report the kernel's distance from the plain version with the reference's
    fp32 prefix sum.  ``segments``: a key of ``SEGMENTS``, what the plan's G
    must satisfy on the tensor-core route."""
    dev = gen.device

    def rand(*shape, scale=1.0, to=dtype):
        return (torch.randn(shape, device=dev, dtype=torch.float32, generator=gen) * scale).to(to)

    if model_layout:
        x = rand(b, s, H, P).transpose(1, 2)
        B, C = (rand(b, s, N, scale=0.5)[:, None].expand(b, H, s, N) for _ in range(2))
        dt = F.softplus(rand(b, s, H, to=torch.float32)).transpose(1, 2)
        loga = -F.softplus(rand(b, s, H, to=torch.float32)).transpose(1, 2)
    else:
        x = rand(b, H, s, P)
        B, C = (rand(b, H, s, N, scale=0.5) for _ in range(2))
        dt = F.softplus(rand(b, H, s, to=torch.float32))
        loga = -F.softplus(rand(b, H, s, to=torch.float32))
    args = [(x, B, C, dt, loga)]
    y, S = ops.ssd_chunk_scan(x, B, C, dt, loga, chunk, out_dtype)
    torch.cuda.synchronize()
    y_want, S_want = ref.ssd_chunk_scan_ref(x, B, C, dt, loga, chunk, out_dtype)
    what = f"ssd_chunk_scan x{tuple(x.shape)} N {N} chunk {chunk} {dtype}"
    err = compare(y, y_want, what)
    # bf16 at zamba2's (chunk, P, N) runs on the tensor cores, all else on the
    # CUDA cores; two heads a block where B and C are shared by the heads
    cs = min(chunk, s)
    plan = _ssd.ssd_plan(x, B, C, cs, y)
    tc = dtype == torch.bfloat16 and (cs, P, N) == (128, 64, 64)
    n_chunks = s // cs
    if plan.route != ("tensor_cores" if tc else "cuda_cores") or (tc and not (
            SEGMENTS[segments](plan.segments, n_chunks)
            and plan.heads_per_block == (2 if model_layout and H % 2 == 0 else 1))):
        raise AssertionError(f"{what}: plan {plan} (expected segments {segments!r})")
    s_err = (S - S_want).abs()
    if S.dtype != torch.float32 or not bool((s_err <= SSD_STATE_TOL * (1 + S_want.abs())).all()):
        raise AssertionError(f"{what}: S_final disagrees with the plain version, max abs err "
                             f"{s_err.max().item()} (rtol = atol = {SSD_STATE_TOL})")
    case = {
        "kernel": "ssd_chunk_scan", "shape": [b, H, s, P, N], "chunk": cs, "route": plan.route,
        "segments": plan.segments, "n_chunks": n_chunks, "heads_per_block": plan.heads_per_block,
        "smem_bytes": plan.smem_bytes, "state_smem_bytes": plan.state_smem_bytes,
        "layout": "model: x (b,s,H,P), B/C (b,s,N) head stride 0" if model_layout
        else "(b,H,s,.) contiguous",
        "dtype": str(dtype).removeprefix("torch."), "y_dtype": str(y.dtype).removeprefix("torch."),
        "max_abs_err": err, "tol": TOL[y.dtype], "S_final_max_abs_err": s_err.max().item(),
        "S_final_tol": SSD_STATE_TOL, "max_abs_plain": y_want.float().abs().max().item(),
        # the worst element's share of its allowance: |err| / (tol (1 + |plain|))
        "worst_share_of_tol": ((y.float() - y_want.float()).abs()
                               / (TOL[y.dtype] * (1 + y_want.float().abs()))).max().item(),
    }
    if vs_fp32_cumsum:
        # a reading, not a check: the reference's arithmetic (fp32 prefix sum)
        # departs from the kernel's by the rounding of cum, amplified by the gate
        y32, S32 = ref.ssd_chunk_scan_ref(x, B, C, dt, loga, chunk, out_dtype, torch.float32)
        case["vs_fp32_cumsum"] = {
            "y_max_abs_err": (y.float() - y32.float()).abs().max().item(),
            "y_max_abs": y32.float().abs().max().item(),
            "S_final_max_abs_err": (S - S32).abs().max().item(),
            "plain_fp64_vs_fp32_cumsum_y_max_abs_diff": (y_want.float() - y32.float()).abs().max().item(),
        }
        del y32, S32
    timings(
        case,
        kernel=(lambda *a: ops.ssd_chunk_scan(*a, chunk, out_dtype), args, iters),
        plain=(lambda *a: ref.ssd_chunk_scan_ref(*a, chunk, out_dtype), args, max(1, iters // 3)),
        library=None,   # no single PyTorch call computes the SSD chunk scan
    )
    flops = b * H * (s // cs) * 2 * cs * (cs * (N + P) + 2 * P * N)
    # each input read once (B/C: their storage, shared by the heads), each output written once
    nbytes = (x.numel() * dtype.itemsize + 2 * b * (1 if model_layout else H) * s * N * dtype.itemsize
              + 2 * b * H * s * 4 + y.numel() * y.dtype.itemsize + S.numel() * 4)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    case["bound_ms"] = max(by_bytes, by_ops)
    case["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    case["kernel_tflops"] = flops / case["kernel_ms"] / 1e9
    return case


# The SSD backward's rule per output, against the plain backward: max abs
# error within TOL of the plain output's largest element (fp32 1e-4, bf16
# 2e-2): dloga is a reverse prefix sum over a chunk of differences that cancel,
# so an element's own size is no scale for its error.
def compare_to_max(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    tol = TOL[want.dtype]
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if got.shape != want.shape or got.dtype != want.dtype or not math.isfinite(err) \
            or not err <= tol * scale:
        raise AssertionError(f"{what}: kernel disagrees with its plain version, max abs err "
                             f"{err} > {tol} x max |plain| {scale}")
    return err


def ssd_bwd_case(b: int, H: int, s: int, P: int, N: int, chunk: int, dtype: torch.dtype,
                 gen: torch.Generator, iters: int, shared: bool,
                 dy_dtype: torch.dtype = torch.float32, ds_final: bool = False) -> dict:
    """The SSD backward kernel against the plain backward
    (``ref.ssd_chunk_scan_bwd_ref``) on the same inputs.  ``shared``: the
    model's layout -- x and dy held as (b, s, H, P) and passed as transposed
    views, B/C as (b, s, N) shared by the heads (their gradients summed over
    the heads), dt/loga as (b, s, H); else every tensor (b, H, s, .)
    contiguous, B/C per head.  ``ds_final``: a gradient of S_final too (the
    model drops S_final).  Fails if the plan's route is not the one the inputs
    call for (tensor cores: bf16 x/B/C at chunk 128, P = N = 64)."""
    dev = gen.device

    def rand(*shape, scale=1.0, to=dtype):
        return (torch.randn(shape, device=dev, dtype=torch.float32, generator=gen) * scale).to(to)

    if shared:
        x, dy = rand(b, s, H, P).transpose(1, 2), rand(b, s, H, P, to=dy_dtype).transpose(1, 2)
        B, C = rand(b, s, N, scale=0.5), rand(b, s, N, scale=0.5)
        dt = F.softplus(rand(b, s, H, to=torch.float32)).transpose(1, 2)
        loga = -F.softplus(rand(b, s, H, to=torch.float32)).transpose(1, 2)
    else:
        x, dy = rand(b, H, s, P), rand(b, H, s, P, to=dy_dtype)
        B, C = rand(b, H, s, N, scale=0.5), rand(b, H, s, N, scale=0.5)
        dt = F.softplus(rand(b, H, s, to=torch.float32))
        loga = -F.softplus(rand(b, H, s, to=torch.float32))
    dS = rand(b, H, P, N, to=torch.float32) if ds_final else None
    args = (x, B, C, dt, loga, dy, dS)
    got = _ssd.ssd_chunk_scan_bwd_cuda(*args, chunk)
    again = _ssd.ssd_chunk_scan_bwd_cuda(*args, chunk)
    torch.cuda.synchronize()
    want = ref.ssd_chunk_scan_bwd_ref(*args, chunk)
    what = f"ssd_chunk_scan_bwd x{tuple(x.shape)} B{tuple(B.shape)} chunk {chunk} {dtype}"
    names = ("dx", "dB", "dC", "ddt", "dloga")
    errs = {n: compare_to_max(g, w, f"{what} {n}") for n, g, w in zip(names, got, want)}
    # no atomics and a fixed order for every sum: two calls agree bit for bit
    for n, g1, g2 in zip(names, got, again):
        if not torch.equal(g1, g2):
            raise AssertionError(f"{what} {n}: two calls on the same inputs differ")
    cs = min(chunk, s)
    n_chunks = s // cs
    plan = _ssd.ssd_bwd_plan(x, B, C, dy, cs)
    tc = plan.route == "tensor_cores"
    if (dtype == torch.bfloat16 and (cs, P, N) == (128, 64, 64)) != tc:
        raise AssertionError(f"ssd_chunk_scan_bwd x{tuple(x.shape)} {dtype} took {plan.route}")
    case = {
        "kernel": "ssd_chunk_scan_bwd", "shape": [b, H, s, P, N], "chunk": cs,
        "route": plan.route, "heads_per_group": plan.heads_per_group, "groups": plan.groups,
        # bf16 terms of each fp32 operand on the tensor cores (dy's: 1 where it is bf16)
        "terms": {"dy": _ssd.bwd_dy_terms(dy_dtype), "S_in_dS_gcb_dcb_xw": _ssd.BWD_TERMS}
        if tc else None,
        # the states pass: each chunk's local states at once (tensor cores) or
        # one block a (b, h, direction) walking the chunks (CUDA cores); then
        # the composition (tensor cores: one thread a float4 of a (b, h)'s
        # P x N, both directions)
        "states_kernel_blocks": n_chunks * H * b if tc else 2 * H * b,
        "compose_kernel_blocks": 2 * -(-b * H * P * N // 4 // 256) if tc else 0,
        "chunk_kernel_blocks": plan.groups * n_chunks * b,
        "smem_bytes": {"states": plan.states_smem_bytes, "chunk": plan.chunk_smem_bytes},
        "layout": "model: x/dy (b,s,H,P), B/C (b,s,N) shared" if shared
        else "(b,H,s,.) contiguous, B/C per head",
        "dtype": str(dtype).removeprefix("torch."), "dy_dtype": str(dy_dtype).removeprefix("torch."),
        "dS_final": ds_final, "bit_identical_twice": True, "max_abs_err_each": errs,
        "max_abs_plain_each": {n: w.float().abs().max().item() for n, w in zip(names, want)},
        "rule": "max abs err <= tol x max |plain| per output", "tol": TOL[dtype],
        "tol_fp32_outputs": TOL[torch.float32],
        # the worst output's error as a share of its allowance
        "worst_share_of_tol": max(errs[n] / (TOL[w.dtype] * w.float().abs().max().item())
                                  for n, w in zip(names, want)),
    }
    case["max_abs_err"] = max(errs.values())
    del got, again, want
    timings(
        case,
        kernel=(lambda *a: _ssd.ssd_chunk_scan_bwd_cuda(*a, chunk), [args], iters),
        plain=(lambda *a: ref.ssd_chunk_scan_bwd_ref(*a, chunk), [args], max(1, iters // 4)),
        library=None,   # no PyTorch call computes the SSD backward
    )
    # operations: per (b, h, chunk) the two P-wide chunk x chunk products
    # (dy x^T, gcb^T dy) over their causal half and five chunk x P x N products
    # (the states S_in and dS, dS B^T, dy S_in, x dS); the three N-wide chunk x
    # chunk products (C B^T, dcb B, dcb^T C) per (b, h, chunk) where B/C are per
    # head, once per (b, chunk) where they are shared (gcb_h = gate_h * C B^T and
    # sum_h dcb_h^T C = (sum_h dcb_h)^T C); at the bf16 tensor-core rate on
    # that route, else the fp32 rate of the CUDA cores
    heads_bc = 1 if shared else H
    pairs = cs * (cs + 1) // 2
    flops = 2 * b * n_chunks * (H * (pairs * 2 * P + 5 * cs * P * N) + heads_bc * pairs * 3 * N)
    nbytes = (2 * x.numel() * dtype.itemsize + dy.numel() * dy_dtype.itemsize
              + 4 * b * heads_bc * s * N * dtype.itemsize + 4 * b * H * s * 4
              + (dS.numel() * 4 if ds_final else 0))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[torch.bfloat16 if tc else torch.float32] * 1e3
    case["ops_rate"] = "bf16 tensor cores" if tc else "fp32 CUDA cores"
    if tc:
        # what the kernels issue: 36 whole 16 x 16 tiles of each causal product,
        # every product of split terms (both operands fp32: six of nine)
        td = _ssd.bwd_dy_terms(dy_dtype)
        both = 6 if td == 3 else 3
        tiles = 36 * 16 * 16
        per_head = 2 * cs * P * N * (both + 3 + 3) + 2 * tiles * P * (td + both)
        states = 2 * cs * P * N * 3 * (2 * n_chunks - 2)
        per_group = 2 * tiles * N * (1 + 3 + 3)
        case["flops_with_terms"] = (b * H * (n_chunks * per_head + states)
                                    + b * n_chunks * plan.groups * per_group)
        case["ops_with_terms_ms"] = case["flops_with_terms"] / PEAK_FLOPS[torch.bfloat16] * 1e3
    case["bound_by_bytes_ms"], case["bound_by_ops_ms"] = by_bytes, by_ops
    case["bound_ms"] = max(by_bytes, by_ops)
    case["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    case["kernel_tflops"] = flops / case["kernel_ms"] / 1e9
    return case


def kernels_phase(cfg, zcfg, mcfg, qcfg, vcfg, xcfg, wcfg, dcfg, pcfg, gcfg,
                  dev: torch.device) -> dict[str, dict]:
    """Every kernel case; returns the case of each kernel at its main paths'
    heaviest shape (zamba2-2.7b's 32k prefill for the three forwards,
    minicpm-2b's training step for the RMSNorm and flash backwards, zamba2's
    for the SSD backward).  ``qcfg``/``vcfg``: qwen3-moe-235b-a22b's and
    phi-3-vision-4.2b's shapes (flash at hd 96 on both routes); ``xcfg``/
    ``wcfg``: xlstm-350m's and whisper-tiny's (flash without a causal mask,
    and over more keys than queries, on both routes); ``dcfg``/``pcfg``/
    ``gcfg``: dbrx-132b's, phi4-mini-3.8b's and granite-8b's (GQA 6:1, 3:1
    and 4:1 at hd 128; phi4-mini's training step, forward with lse and
    backward)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    hd = cfg.resolved_head_dim
    bf16, fp32 = torch.bfloat16, torch.float32
    zh, zhd = zcfg.n_heads, zcfg.resolved_head_dim
    H, N = zcfg.ssm_heads, zcfg.ssm_state
    P = zcfg.ssm_expand * zcfg.d_model // H
    ssd_main = ssd_case(1, H, ZAMBA_SEQ, P, N, 128, bf16, gen, 3, True, fp32, vs_fp32_cumsum=True,
                        segments="many")
    # the shapes of zamba2's 32k forward: the shared attention, each norm of it
    flash_main = flash_case(1, zh, zh, ZAMBA_SEQ, ZAMBA_SEQ, zhd, bf16, gen, 3, True,
                            q_scale=4.0, by_head=True)
    rmsnorm_main = rmsnorm_case((1, ZAMBA_SEQ, zcfg.d_model), bf16, gen, 50)
    zamba_cases = [
        ssd_main,
        flash_main,
        rmsnorm_main,
        rmsnorm_case((8, 1, zcfg.d_model), bf16, gen, 200),      # zamba2's decode, 8 lanes
        ssd_case(1, H, 128, P, N, 128, bf16, gen, 20, True, fp32),       # s == chunk
        ssd_case(2, H, 1024, P, N, 128, bf16, gen, 10, True, fp32, segments="any"),   # b = 2
        ssd_case(1, H, 1024, P, N, 128, bf16, gen, 10, True, fp32, segments="ragged"),
        # b * H fills the card alone; B/C per head: one head a block, y in bf16
        ssd_case(4, H, 512, P, N, 128, bf16, gen, 10, False),
        ssd_case(1, 8, 384, P, N, 128, fp32, gen, 10, True),
        # the shapes of the reference's tests/test_kernels.py, y in x's dtype
        *(ssd_case(b, h, s, p, n, c, dt, gen, 10, False)
          for dt in (fp32, bf16)
          for b, h, s, p, n, c in ((2, 2, 64, 16, 8, 16), (1, 4, 128, 32, 16, 32),
                                   (2, 1, 32, 8, 8, 32))),
        # zamba2's shared attention, hd = 80: tensor cores (4096 tokens is the
        # yardstick of earlier runs), then the CUDA-core kernel
        flash_case(1, zh, zh, ZAMBA_ATTN_SEQ, ZAMBA_ATTN_SEQ, zhd, bf16, gen, 10, True),
        flash_case(2, 8, 8, 300, 300, zhd, bf16, gen, 20, True),
        flash_case(1, 4, 4, 150, 150, zhd, fp32, gen, 20, False),
        flash_case(1, 4, 2, 130, 130, zhd, bf16, gen, 20, False, offset=1),
    ]
    cases = [
        rmsnorm_case((1, 1024, cfg.d_model), bf16, gen, 200),    # prefill, largest bucket
        rmsnorm_case((8, 1, cfg.d_model), bf16, gen, 200),       # decode, 8 lanes
        rmsnorm_case((3, 37, 1000), fp32, gen, 50),              # ragged: d % 4 == 0 only
        rmsnorm_case((5, 4099), bf16, gen, 50),                  # unaligned rows: scalar path
        flash_case(1, cfg.n_heads, cfg.n_kv_heads, 1024, 1024, hd, bf16, gen, 20, True),
        flash_case(1, cfg.n_heads, cfg.n_kv_heads, 128, 128, hd, bf16, gen, 50, True),
        # bf16 with 16-byte-aligned rows runs on the tensor cores, all else on the CUDA cores
        flash_case(2, 4, 2, 75, 203, 64, fp32, gen, 20, False),  # ragged, sq != skv
        flash_case(1, 4, 4, 96, 96, 16, fp32, gen, 20, False),
        flash_case(2, 4, 2, 75, 203, 64, bf16, gen, 20, False),
        flash_case(1, 4, 4, 96, 96, 16, bf16, gen, 20, True),
        flash_case(1, 8, 1, 130, 130, 32, bf16, gen, 20, False),
        flash_case(1, 8, 2, 200, 200, 128, bf16, gen, 20, False, offset=1),
        flash_case(1, 4, 2, 100, 70, 64, bf16, gen, 20, False, causal=False),   # sq > skv
        flash_case(1, 4, 2, 100, 70, 32, fp32, gen, 20, False, causal=False),
        rmsnorm_case((1, 1024, zcfg.d_model), bf16, gen, 200),   # zamba2-2.7b's width
        # the register route's other vector counts (2, 4, 9, 12, 24 per lane),
        # the configs' other widths; at 384 lanes 16-31 mask their second vector
        *(rmsnorm_case((256, d), bf16, gen, 50) for d in (384, 1024, 2304, 3072, 6144)),
    ]
    # minicpm-2b's training step: 4 x 1024 tokens, 36 heads of 64, d_model 2304
    mh, mhd, md = mcfg.n_heads, mcfg.resolved_head_dim, mcfg.d_model
    flash_bwd_main = flash_bwd_case(4, mh, mh, 1024, 1024, mhd, bf16, gen, 10, True)
    rmsnorm_bwd_main = rmsnorm_bwd_case((4, 1024, md), bf16, gen, 50)
    train_cases = [
        flash_bwd_main,
        flash_bwd_case(4, mh, mh, 1024, 1024, mhd, fp32, gen, 3, True),   # the launcher's fp32
        flash_bwd_case(1, 32, 2, 1024, 1024, 128, bf16, gen, 10, True),    # GQA, hd 128
        flash_bwd_case(2, 8, 8, 300, 300, 80, bf16, gen, 20, True),        # hd 80, ragged
        flash_bwd_case(1, 4, 2, 75, 203, 64, fp32, gen, 20, False),        # causal offset
        flash_bwd_case(1, 4, 2, 100, 70, 32, fp32, gen, 20, False, causal=False),
        flash_bwd_case(4, mh, mh, 1024, 1024, mhd, bf16, gen, 3, True, offset=1),  # CUDA cores
        # the forward's lse leaves out as it was: wgmma and the CUDA cores
        flash_lse_case(4, mh, mh, 1024, mhd, bf16, gen),
        flash_lse_case(4, mh, mh, 1024, mhd, fp32, gen),
        flash_lse_case(2, 8, 8, 300, 80, bf16, gen),
        # the forwards at the training step's shapes: bf16, and fp32 with lse
        # (the launcher's dtype, as its training forward calls it)
        flash_case(4, mh, mh, 1024, 1024, mhd, bf16, gen, 10, True),
        flash_case(4, mh, mh, 1024, 1024, mhd, fp32, gen, 10, True, with_lse=True),
        rmsnorm_case((4, 1024, md), bf16, gen, 50),
        rmsnorm_bwd_main,
        rmsnorm_bwd_case((4, 1024, md), fp32, gen, 50),
        rmsnorm_bwd_case((8, 64, 64), bf16, gen, 50),
        rmsnorm_bwd_case((3, 37, 1000), fp32, gen, 50),   # block route, ragged
        rmsnorm_bwd_case((5, 4099), bf16, gen, 50),       # unaligned rows: scalar path
        rmsnorm_bwd_case((1, 4096, zcfg.d_model), bf16, gen, 50),   # zamba2-2.7b's width, 10 vectors
        rmsnorm_bwd_case((256, 6144), bf16, gen, 50),     # 24 vectors a lane: partials shared
    ]
    # zamba2-2.7b's training step: 4 x 1024 tokens; the SSD backward (model
    # layout, B/C shared by the heads, fp32 dy as mamba2_fwd's fp32 y gives it),
    # the shared block's flash forward with lse and backward at hd 80, its norms
    ssd_bwd_main = ssd_bwd_case(4, H, 1024, P, N, 128, bf16, gen, 5, True)
    zamba_train_cases = [
        ssd_bwd_main,
        ssd_bwd_case(4, H, 1024, P, N, 128, bf16, gen, 5, True, bf16),     # bf16 dy: one term
        ssd_bwd_case(4, H, 1024, P, N, 128, fp32, gen, 3, True),           # the launcher's fp32
        ssd_bwd_case(2, H, 1024, P, N, 128, bf16, gen, 3, False, ds_final=True),   # per head
        ssd_bwd_case(1, H, 384, P, N, 128, bf16, gen, 10, True, ds_final=True),    # 300 tokens, padded
        ssd_bwd_case(1, 8, 384, P, N, 128, fp32, gen, 10, True, ds_final=True),
        # the reference's shapes, B/C per head, dy in x's dtype
        *(ssd_bwd_case(b, h, s, p, n, c, dt, gen, 10, False, dt, ds_final=True)
          for dt in (fp32, bf16)
          for b, h, s, p, n, c in ((2, 2, 64, 16, 8, 16), (1, 4, 128, 32, 16, 32),
                                   (2, 1, 32, 8, 8, 32))),
        flash_case(4, zh, zh, 1024, 1024, zhd, bf16, gen, 10, True, with_lse=True),
        flash_bwd_case(4, zh, zh, 1024, 1024, zhd, bf16, gen, 10, True),
        rmsnorm_case((4, 1024, zcfg.d_model), bf16, gen, 50),
        rmsnorm_bwd_case((4, 1024, zcfg.d_model), bf16, gen, 50),
    ]
    # qwen3-moe-235b-a22b's prefill and training step (GQA 16:1 at hd 128, d
    # 4096), phi-3-vision-4.2b's step (576 patches + 1024 tokens, MHA at hd 96,
    # d 3072) and hd 96 on the CUDA cores (fp32, ragged, unaligned bf16)
    qh, qkv, qhd, qd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.resolved_head_dim, qcfg.d_model
    vh, vhd, vd, vs = vcfg.n_heads, vcfg.resolved_head_dim, vcfg.d_model, TRAIN_SEQ + vcfg.n_patches
    b = TRAIN_BATCH
    moe_vlm_cases = [
        flash_case(1, qh, qkv, 1024, 1024, qhd, bf16, gen, 20, True),    # the largest bucket
        flash_case(b, qh, qkv, TRAIN_SEQ, TRAIN_SEQ, qhd, bf16, gen, 10, True, with_lse=True),
        flash_bwd_case(b, qh, qkv, TRAIN_SEQ, TRAIN_SEQ, qhd, bf16, gen, 10, True),
        flash_case(b, vh, vh, vs, vs, vhd, bf16, gen, 10, True, with_lse=True),
        flash_bwd_case(b, vh, vh, vs, vs, vhd, bf16, gen, 10, True),
        flash_lse_case(b, vh, vh, vs, vhd, bf16, gen),
        flash_case(b, vh, vh, vs, vs, vhd, fp32, gen, 3, True, with_lse=True),   # the launcher's
        flash_bwd_case(b, vh, vh, vs, vs, vhd, fp32, gen, 3, True),
        flash_lse_case(b, vh, vh, vs, vhd, fp32, gen),
        flash_case(1, 4, 4, 150, 150, vhd, fp32, gen, 20, False),            # ragged
        flash_case(1, 4, 4, 150, 150, vhd, bf16, gen, 20, False, offset=1),  # unaligned
        flash_bwd_case(1, 4, 4, 150, 150, vhd, bf16, gen, 20, False, offset=1),
        rmsnorm_case((b, vs, vd), bf16, gen, 50),
        rmsnorm_bwd_case((b, vs, vd), bf16, gen, 50),
        rmsnorm_case((b, TRAIN_SEQ, qd), bf16, gen, 50),
        rmsnorm_bwd_case((b, TRAIN_SEQ, qd), bf16, gen, 50),
    ]
    # xlstm-350m's blocks (d 1024: its training step's 4 x 256 tokens, decode's
    # 8 lanes) and whisper-tiny's (d 384, 6 heads of 64): the encoder's
    # self-attention over 1500 frames (non-causal; 1500 = 11 x 128 + 92, the
    # last key tile ragged), the decoder's cross-attention (448 queries over
    # the 1500 frames, non-causal) and its causal self-attention over 448
    # tokens; forward with lse and backward, bf16 on wgmma and fp32 (the
    # launcher's dtype) on the CUDA cores
    wh, whd, wd = wcfg.n_heads, wcfg.resolved_head_dim, wcfg.d_model
    ssm_audio_cases = [
        *(case for shape in ((b, XLSTM_TRAIN_SEQ, xcfg.d_model), (b, N_FRAMES, wd),
                             (b, WHISPER_SEQ, wd))
          for case in (rmsnorm_case(shape, bf16, gen, 50), rmsnorm_bwd_case(shape, bf16, gen, 50))),
        rmsnorm_case((8, 1, xcfg.d_model), bf16, gen, 200),
        rmsnorm_case((8, 1, wd), bf16, gen, 200),
        *(case for sq, skv, causal in ((N_FRAMES, N_FRAMES, False), (WHISPER_SEQ, N_FRAMES, False),
                                       (WHISPER_SEQ, WHISPER_SEQ, True))
          for dt, iters in ((bf16, 10), (fp32, 3))
          for case in (flash_case(b, wh, wh, sq, skv, whd, dt, gen, iters, True, causal=causal,
                                  q_scale=4.0, with_lse=True),
                       flash_bwd_case(b, wh, wh, sq, skv, whd, dt, gen, iters, True, causal=causal),
                       flash_lse_case(b, wh, wh, sq, whd, dt, gen, skv=skv, causal=causal))),
    ]
    new_config_cases = config_cases(dcfg, pcfg, gcfg, gen)
    # glm4-9b's meshed training step on four cards, a (2, 2) mesh: each rank's
    # local shards, 4 of the 8 sequences, 16 of the 32 q heads on 1 of the 2
    # KV heads (GQA 16:1), forward with lse and backward
    gh, gkv, gb = cfg.n_heads // 2, cfg.n_kv_heads // 2, GLM4_CARDS_BATCH // 2
    new_config_cases += [
        flash_case(gb, gh, gkv, TRAIN_SEQ, TRAIN_SEQ, hd, bf16, gen, 10, True, with_lse=True),
        flash_bwd_case(gb, gh, gkv, TRAIN_SEQ, TRAIN_SEQ, hd, bf16, gen, 10, True),
    ]
    # dbrx-132b on four cards (mesh_cards_dbrx): its training step's shards on
    # (2, 2), 4 of the 8 sequences, 24 of the 48 q heads on 4 of the 8 KV heads
    # (GQA 6:1), forward with lse and backward, its norms at d 6144; the
    # decodes' norms, 8 lanes a rank on (1, 4) and one card, 4 on (2, 2)
    dh, dkv, dd = dcfg.n_heads // 2, dcfg.n_kv_heads // 2, dcfg.d_model
    new_config_cases += [
        flash_case(gb, dh, dkv, TRAIN_SEQ, TRAIN_SEQ, dcfg.resolved_head_dim, bf16, gen, 10, True,
                   with_lse=True),
        flash_bwd_case(gb, dh, dkv, TRAIN_SEQ, TRAIN_SEQ, dcfg.resolved_head_dim, bf16, gen, 10,
                       True),
        rmsnorm_case((gb, TRAIN_SEQ, dd), bf16, gen, 50),
        rmsnorm_bwd_case((gb, TRAIN_SEQ, dd), bf16, gen, 50),
        rmsnorm_case((DBRX_CARDS_LANES, 1, dd), bf16, gen, 200),
        rmsnorm_case((DBRX_CARDS_LANES // 2, 1, dd), bf16, gen, 200),
    ]
    emit({"phase": "kernels", "cases": cases + zamba_cases + train_cases + zamba_train_cases
          + moe_vlm_cases + ssm_audio_cases + new_config_cases})
    return {"rmsnorm": rmsnorm_main, "flash_attention": flash_main, "ssd_chunk_scan": ssd_main,
            "rmsnorm_bwd": rmsnorm_bwd_main, "flash_attention_bwd": flash_bwd_main,
            "ssd_chunk_scan_bwd": ssd_bwd_main}


def config_cases(dcfg, pcfg, gcfg, gen: torch.Generator) -> list[dict]:
    """dbrx-132b's and granite-8b's largest prefill bucket (GQA 48:8 and 32:8
    at hd 128; d 6144 and 4096), phi4-mini-3.8b's (24:8, d 3072) and its
    training step: 4 x 1024 tokens, forward with lse and backward at the odd
    group of 3, its norms forward and backward."""
    bf16, b = torch.bfloat16, TRAIN_BATCH
    ph, pkv, phd, pd = pcfg.n_heads, pcfg.n_kv_heads, pcfg.resolved_head_dim, pcfg.d_model
    return [
        flash_case(1, dcfg.n_heads, dcfg.n_kv_heads, 1024, 1024, dcfg.resolved_head_dim, bf16,
                   gen, 20, True),
        flash_case(1, gcfg.n_heads, gcfg.n_kv_heads, 1024, 1024, gcfg.resolved_head_dim, bf16,
                   gen, 20, True),
        flash_case(1, ph, pkv, 1024, 1024, phd, bf16, gen, 20, True),
        flash_case(b, ph, pkv, TRAIN_SEQ, TRAIN_SEQ, phd, bf16, gen, 10, True, with_lse=True),
        flash_bwd_case(b, ph, pkv, TRAIN_SEQ, TRAIN_SEQ, phd, bf16, gen, 10, True),
        flash_lse_case(b, ph, pkv, TRAIN_SEQ, phd, bf16, gen),
        rmsnorm_case((1, 1024, dcfg.d_model), bf16, gen, 200),
        rmsnorm_case((1, 1024, pd), bf16, gen, 200),
        rmsnorm_case((b, TRAIN_SEQ, pd), bf16, gen, 50),
        rmsnorm_bwd_case((b, TRAIN_SEQ, pd), bf16, gen, 50),
    ]


# ------------------------------------------------------------------- parity
PLAIN = {"rmsnorm": ref.rmsnorm_ref, "flash_attention": ref.flash_attention_ref,
         "ssd_chunk_scan": ref.ssd_chunk_scan_ref}


def plain_kernels(keep: str | None = None):
    """Route the model's kernel calls, all but ``keep``'s, to the plain
    versions (comparison only)."""
    return mock.patch.multiple(ops, **{name: fn for name, fn in PLAIN.items() if name != keep})


@contextlib.contextmanager
def cpu_branch_kernels():
    """Every kernel call of ``ops`` on a CUDA tensor computes what ``ops``
    computes for a CPU tensor -- the plain forwards and, where autograd
    records, the plain analytic backwards -- so that a step on the card takes
    the route the dry run's trace takes on meta (comparison only)."""
    def flash(q, k, v, causal, with_lse=False):
        _fa.check_shapes(q, k, v, causal)
        if not with_lse:
            return ref.flash_attention_ref(q, k, v, causal)
        out32, lse = ref.flash_attention_lse_ref(q.float(), k.float(), v.float(), causal)
        out = out32.to(q.dtype)
        return out, lse, None if q.dtype == torch.float32 else (out32 - out.float()).to(q.dtype)

    with mock.patch.object(_fa, "flash_attention_cuda", flash), \
            mock.patch.object(_fa, "flash_attention_bwd_cuda", ref.flash_attention_bwd_ref), \
            mock.patch.object(_rms, "rmsnorm_cuda", ref.rmsnorm_ref), \
            mock.patch.object(_rms, "rmsnorm_bwd_cuda", ref.rmsnorm_bwd_ref):
        yield


def leaf_paths(tree, path: str = "") -> list[str]:
    """The paths of ``tree_leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{path}/{i}")]
    return [path]


# leaves held in fp32 whatever the weights' dtype
FP32_LEAVES = ("norm_scale", "A_log", "D", "dt_bias", "router")


def cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: v if k in FP32_LEAVES else cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype)


def parity_phase(cfg, dev: torch.device) -> None:
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    n_pages, ps, max_blocks, lanes = 64, 16, 16, 8
    prompt_len, bucket, n_decode = 200, 256, 3
    gen = torch.Generator(device=dev).manual_seed(2)
    master = build_model(cfg4, ModelOptions("float32", "float32"), dev).init(gen)
    prompt = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    prompt[0, :prompt_len] = torch.randint(0, cfg.vocab, (prompt_len,), device=dev, generator=gen)
    step_tokens = torch.randint(0, cfg.vocab, (n_decode, lanes, 1), device=dev, generator=gen)
    table = torch.full((lanes, max_blocks), -1, dtype=torch.int32, device=dev)
    n_blocks = -(-(prompt_len + n_decode) // ps)
    table[0, :n_blocks] = torch.arange(n_blocks, dtype=torch.int32, device=dev)
    active = torch.zeros(lanes, dtype=torch.bool, device=dev)
    active[0] = True

    @torch.no_grad()
    def run(model, params) -> list[torch.Tensor]:
        pages = model.init_paged_cache(n_pages, ps)
        logits, _ = model.prefill_paged(params, pages, table[0], prompt_len, prompt)
        outs = [logits[0, :prompt_len].float()]
        lengths = torch.zeros(lanes, dtype=torch.int32, device=dev)
        for i in range(n_decode):
            lengths[0] = prompt_len + i
            logits, _ = model.decode_step_paged(params, pages, table, lengths, step_tokens[i], active)
            outs.append(logits[0].float())
        torch.cuda.synchronize()
        return outs

    report = {"phase": "parity", "n_layers": 4, "prompt_len": prompt_len, "bucket": bucket,
              "decode_steps": n_decode}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = build_model(cfg4, ModelOptions(name, name), dev)
        params = cast(master, dtype)
        ops.reset_launch_counts()
        through_kernels = run(model, params)
        counts = ops.launch_counts()
        with plain_kernels():
            through_plain = run(model, params)
        if ops.launch_counts() != counts or counts["flash_attention"] != 4:
            raise AssertionError(f"parity: the plain run launched kernels, or the kernel run "
                                 f"did not: {counts} -> {ops.launch_counts()}")
        diff = max((a - b).abs().max().item() for a, b in zip(through_kernels, through_plain))
        scale = max(b.abs().max().item() for b in through_plain)
        tol = 1e-3 if dtype == torch.float32 else 2e-2 * scale
        finite = all(torch.isfinite(a).all().item() for a in through_kernels)
        if not finite or not diff <= tol or through_kernels[0].shape != (prompt_len, cfg.padded_vocab):
            raise AssertionError(f"parity {name}: max abs logit diff {diff} > {tol} (finite={finite})")
        report[name] = {"max_abs_logit_diff": diff, "tol": tol, "max_abs_logit": scale}
        del params
    emit(report)


# ---------------------------------------------------------------------- MoE
# qwen3-moe-235b-a22b does not fit one card at its 94 layers (4.98 GB of bf16
# weights a layer): serving keeps 12 (59.7 GB, with 2.49 GB of embedding and
# head), training 1 (16 bytes a parameter of weights, gradients and AdamW
# moments: 59.7 GB); widths are the published ones.  Full depth needs the
# parallelism layer (ROADMAP A6).
MOE_SERVE_LAYERS = 12
MOE_TRAIN_LAYERS = 1
# dbrx-132b (16 experts of 10752, top-4): 6.52 GB of bf16 weights a layer
# (3.259 G parameters) and 2.47 GB of embedding and untied head; serving keeps
# 9 of its 40 layers (61.1 GB).  Its training is left to more than one card:
# one layer's fp32 state alone is 16 B x 4.49 G = 71.9 GB.
DBRX_SERVE_LAYERS = 9


def recorded_routes():
    """(log, patch): under ``patch`` every ``moe_route`` call appends its
    (expert_idx, keep), each (tokens, k), to ``log`` (comparison only)."""
    log, real = [], model_layers.moe_route

    def route(logits, top_k, capacity, expert_idx=None):
        out = real(logits, top_k, capacity, expert_idx)
        log.append((out[2].reshape(-1, top_k), out[4].reshape(-1, top_k)))
        return out

    return log, mock.patch.object(model_layers, "moe_route", route)


def pinned_routes(log):
    """(flips, patch): under ``patch`` the i-th ``moe_route`` call takes the
    choices of ``log``'s i-th call in place of its own, and ``flips`` gathers
    how many of its own choices differed (comparison only)."""
    calls, flips, real = iter(log), [], model_layers.moe_route

    def route(logits, top_k, capacity, expert_idx=None):
        own = real(logits, top_k, capacity)[2]
        pinned = next(calls)[0].view_as(own)
        flips.append((own != pinned).sum())
        return real(logits, top_k, capacity, pinned)

    return flips, mock.patch.object(model_layers, "moe_route", route)


def moe_parity_phase(cfg, dev: torch.device, n_layers: int = 2, phase: str = "moe_parity") -> None:
    """qwen3-moe-235b-a22b at full width and ``n_layers`` layers: one padded
    prefill (its bucket's padding routes and takes capacity, as in the
    reference) and a few paged decode steps (8 lanes, 7 idle, which route
    too), logits through the kernels against logits through the plain
    versions, ``parity``'s rule (fp32 within TOL[float32] elementwise, bf16
    within TOL[bfloat16] times the largest |logit|).  The plain run takes the
    kernel run's routing choices (``pinned_routes``).  fp32: its own choices
    must be the same.  bf16: where a kernel rounds the normed input one step
    apart from the plain version, a near-tie at the 8th of 128 choices flips
    (and, through capacity, later pairs' kept flags); a flipped token's
    output then differs wholly and reaches every later token of its sequence
    through attention (holding only the positions whose own routes agree kept
    fewer than half of them, and those outside the rule), so the share of its
    own choices that differ is reported, not held."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_pages, ps, max_blocks, lanes = 64, 16, 16, 8
    prompt_len, bucket, n_decode = 200, 256, 3
    gen = torch.Generator(device=dev).manual_seed(2)
    master = build_model(cfg, ModelOptions("float32", "float32"), dev).init(gen)
    prompt = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    prompt[0, :prompt_len] = torch.randint(0, cfg.vocab, (prompt_len,), device=dev, generator=gen)
    step_tokens = torch.randint(0, cfg.vocab, (n_decode, lanes, 1), device=dev, generator=gen)
    table = torch.full((lanes, max_blocks), -1, dtype=torch.int32, device=dev)
    n_blocks = -(-(prompt_len + n_decode) // ps)
    table[0, :n_blocks] = torch.arange(n_blocks, dtype=torch.int32, device=dev)
    active = torch.zeros(lanes, dtype=torch.bool, device=dev)
    active[0] = True

    @torch.no_grad()
    def run(model, params) -> list[torch.Tensor]:
        pages = model.init_paged_cache(n_pages, ps)
        logits, _ = model.prefill_paged(params, pages, table[0], prompt_len, prompt)
        outs = [logits[0, :prompt_len, :cfg.vocab].float()]
        lengths = torch.zeros(lanes, dtype=torch.int32, device=dev)
        for i in range(n_decode):
            lengths[0] = prompt_len + i
            logits, _ = model.decode_step_paged(params, pages, table, lengths, step_tokens[i], active)
            outs.append(logits[0, :, :cfg.vocab].float())
        torch.cuda.synchronize()
        return outs

    report = {"phase": phase, "model": cfg.name, "n_layers": n_layers,
              "n_experts": cfg.n_experts, "top_k": cfg.top_k, "prompt_len": prompt_len,
              "bucket": bucket, "decode_steps": n_decode,
              "rule": "the plain run takes the kernel run's routing choices; fp32: its own "
                      "must be the same"}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = build_model(cfg, ModelOptions(name, name), dev)
        params = cast(master, dtype)
        ops.reset_launch_counts()
        log, recording = recorded_routes()
        with recording:
            through_kernels = run(model, params)
        counts = ops.launch_counts()
        flips, pinning = pinned_routes(log)
        with plain_kernels(), pinning:
            through_plain = run(model, params)
        if ops.launch_counts() != counts or counts["flash_attention"] != n_layers:
            raise AssertionError(f"{phase}: the plain run launched kernels, or the kernel run "
                                 f"did not: {counts} -> {ops.launch_counts()}")
        # every routed (token, layer, k): the bucket's padding and the idle lanes too
        n_routes = sum(i.numel() for i, _ in log)
        flipped = sum(int(f) for f in flips)
        scale = max(b.abs().max().item() for b in through_plain)
        finite = all(torch.isfinite(a).all().item() for a in through_kernels)
        if dtype == torch.float32:
            if flipped:
                raise AssertionError(f"{phase} float32: {flipped} of {n_routes} routes differ")
            diff = max(compare(a, b, f"{phase} float32 logits")
                       for a, b in zip(through_kernels, through_plain))
            tol = TOL[dtype]
        else:
            diff = max((a - b).abs().max().item() for a, b in zip(through_kernels, through_plain))
            tol = TOL[dtype] * scale
        if not finite or not diff <= tol:
            raise AssertionError(f"{phase} {name}: max abs logit diff {diff} > {tol} "
                                 f"(finite={finite})")
        report[name] = {"max_abs_logit_diff": diff, "tol": tol, "max_abs_logit": scale,
                        "routes": n_routes, "routes_the_plain_run_would_flip": flipped,
                        "route_flip_share": flipped / n_routes, "launches": counts}
        del params
    emit(report)


# -------------------------------------------------------------------- serve
# ---------------------------------------------------------------- placement
# bench_latency's gpt-7b and its scale-tier workload: 104 minipods x 96 nodes
PLACE_MODEL7B = dict(name="gpt-7b", hidden=4096, layers=32, vocab=50304, seq_len=2048,
                     global_batch=1024, micro_batch=1, d_ff=16384)
PLACE_PODS, PLACE_NODES_PER_POD = 104, 96
PLACE_ALPHA, PLACE_BUDGET_S = 0.3, 1.0
# the scheduler registry's built-in placement policies, by name: importing
# ``repro_torch.faults`` adds the "elastic" repair front end to the registry
PLACE_POLICIES = ("best-fit", "gpu-packing", "hier", "mip", "random-fit", "topo-aware")


def host_cpu_model() -> str:
    """The host's CPU as /proc/cpuinfo describes it (the placement phase's
    times are the host's): its model name, with vendor, family, model, MHz and
    the CPU count beside it, since a virtual machine may report the name as
    "unknown"."""
    fields: dict[str, str] = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break                     # the first processor's block
            key, _, value = line.partition(":")
            fields[key.strip()] = value.strip()
    return (f"{fields.get('model name', 'unknown')} ({fields.get('vendor_id', '?')} "
            f"family {fields.get('cpu family', '?')} model {fields.get('model', '?')}, "
            f"{fields.get('cpu MHz', '?')} MHz, {os.cpu_count()} CPUs)")


def timed_schedule(name: str, comm, cluster, **kw):
    """One request through the registry's ``name`` at the phase's alpha and
    budget; returns the result and its wall seconds."""
    t0 = time.perf_counter()
    res = get_scheduler(name).schedule(ScheduleRequest(
        comm=comm, cluster=cluster, alpha=PLACE_ALPHA, time_budget=PLACE_BUDGET_S, **kw))
    return res, time.perf_counter() - t0


def _valid_placement(res, comm, cluster, what: str) -> None:
    ids = res.placement.node_ids()
    if len(ids) != comm.n_cells or len(set(ids)) != len(ids) or \
            not all(cluster.is_free(n) for n in ids):
        raise AssertionError(f"{what}: invalid placement ({len(ids)} nodes, "
                             f"{len(set(ids))} distinct, {comm.n_cells} cells)")


def placement_phase(card: str, cpu: str) -> dict:
    """The scheduling core on the card's host, in ``examples/serve.py``'s
    order (place the replicas, then serve one): (a) two glm4-9b replicas
    (TP 8, PP 2) placed through ``place_replicas`` on a 4 x 4 cluster; (b)
    the "hier" tier at ``bench_latency``'s 10k-node workload -- cold, flat
    MILP, warm re-solve after one node fails, the same request again; (c) a
    9600-GPU job (TP 8, PP 8, 150 DP groups, the paper's scale) on that
    cluster with 30 % of its nodes taken, through each built-in policy, and
    the Arnold rank grid of the "hier" placement.  Returns (c)'s results by
    policy."""
    # (a) replicas, as the serve example places them
    cluster = Cluster.uniform(4, 4)
    spec = ReplicaSpec(model=serving_model_spec(get_config("glm4-9b")), tp=8, pp=2, n_gpus=16)
    t0 = time.perf_counter()
    replicas = place_replicas(cluster, 2, spec, scheduler="mip,topo-aware")
    replicas_s = time.perf_counter() - t0
    ids = replicas.node_ids()
    if len(ids) != 2 * spec.n_nodes or len(set(ids)) != len(ids) or \
            cluster.n_free != cluster.n_nodes - len(ids):
        raise AssertionError(f"replicas overlap or hold the wrong nodes: {ids}")
    serve_replicas = [{"replica": p.replica_id, "node_ids": p.node_ids, "method": p.method,
                       "served_by": p.result.stats.get("served_by"),
                       "pp_spread": p.result.pp_spread} for p in replicas.placements]
    replicas.release()
    if cluster.n_free != cluster.n_nodes:
        raise AssertionError(f"release left {cluster.n_nodes - cluster.n_free} nodes taken")

    # (b) the scale tier: 9984 nodes, a 4096-GPU job, a 1 s budget
    model = ModelSpec(**PLACE_MODEL7B)
    cluster = Cluster.uniform(PLACE_PODS, PLACE_NODES_PER_POD)
    comm = build_comm_matrix(JobSpec(n_gpus=4096, tp=8, pp=8, model=model))

    cold, cold_wall = timed_schedule("hier", comm, cluster)
    flat, flat_wall = timed_schedule("mip", comm, cluster)
    victim = cold.placement.node_ids()[0]
    warm, warm_wall = timed_schedule("hier", comm, cluster, prev_placement=cold.placement,
                                     dirty_nodes=frozenset([victim]),
                                     excluded_nodes=frozenset([victim]))
    again, again_wall = timed_schedule("hier", comm, cluster)
    for res, what in ((cold, "hier cold"), (flat, "flat mip"), (again, "hier again")):
        _valid_placement(res, comm, cluster, what)
    if victim in warm.placement.node_ids():
        raise AssertionError("the warm re-solve kept the failed node")
    hier_ws = weighted_spread(cold.placement, PLACE_ALPHA)
    flat_ws = weighted_spread(flat.placement, PLACE_ALPHA)
    if hier_ws > 1.1 * flat_ws:
        raise AssertionError(f"hier weighted spread {hier_ws} > 1.1 x flat {flat_ws}")
    if warm.method != "hier-warm" or again.method != "hier-cached":
        raise AssertionError(f"warm {warm.method!r}, repeat {again.method!r}: expected "
                             "'hier-warm' and 'hier-cached'")
    scale = {
        "cluster_nodes": cluster.n_nodes, "job_nodes": comm.n_cells,
        "comm_shape": list(comm.shape), "alpha": PLACE_ALPHA, "budget_s": PLACE_BUDGET_S,
        "hier_cold_s": cold.solve_seconds, "hier_cold_wall_s": cold_wall,
        "hier_method": cold.method, "blocks": cold.stats["n_blocks"],
        "blocks_touched": cold.stats["blocks_touched"],
        "coarse_method": cold.stats["coarse_method"], "fine_methods": cold.stats["fine_methods"],
        "mip_flat_s": flat.solve_seconds, "mip_flat_wall_s": flat_wall, "mip_method": flat.method,
        "hier_weighted_spread": hier_ws, "flat_weighted_spread": flat_ws,
        "hier_warm_s": warm.solve_seconds, "hier_warm_wall_s": warm_wall,
        "warm_speedup_x": cold.solve_seconds / max(warm.solve_seconds, 1e-9),
        "repeat_method": again.method, "repeat_s": again.solve_seconds,
        "repeat_wall_s": again_wall, "cache": again.stats["cache"],
    }

    # (c) the paper's scale: 9600 GPUs on the same cluster, 30 % of it taken
    cluster = Cluster.uniform(PLACE_PODS, PLACE_NODES_PER_POD)
    rng = np.random.default_rng(0)
    cluster.allocate(rng.choice(cluster.n_nodes, int(cluster.n_nodes * 0.3),
                                replace=False).tolist())
    comm = build_comm_matrix(JobSpec(n_gpus=9600, tp=8, pp=8, model=model))
    policies, results = {}, {}
    for name in PLACE_POLICIES:
        res, wall = timed_schedule(name, comm, cluster)
        _valid_placement(res, comm, cluster, name)
        results[name] = res
        policies[name] = {"method": res.method, "dp_spread": res.dp_spread,
                          "pp_spread": res.pp_spread, "solve_s": res.solve_seconds,
                          "wall_s": wall,
                          "weighted_spread": weighted_spread(res.placement, PLACE_ALPHA)}
    placed = results["hier"]
    axes = ("pipe", "data", "model")
    shape = (comm.n_cols, comm.job.dp, 8)
    grid = arnold_rank_grid(placed.placement, 8, shape, np.arange(cluster.n_nodes * 8))
    per_pod = PLACE_NODES_PER_POD * 8
    spreads = {"model_nodes": grid_group_spread(grid, axes, "model", 8),
               "data_pods": grid_group_spread(grid, axes, "data", per_pod),
               "pipe_pods": grid_group_spread(grid, axes, "pipe", per_pod)}
    want = {"model_nodes": 1, "data_pods": max(placed.dp_spread, 1),
            "pipe_pods": max(placed.pp_spread, 1)}
    if spreads != want:
        raise AssertionError(f"rank grid spreads {spreads}, expected {want}")
    emit({"phase": "placement", "card": card, "host_cpu": cpu,
          "serve_replicas": {"model": "glm4-9b", "tp": spec.tp, "pp": spec.pp,
                             "wall_s": replicas_s, "replicas": serve_replicas},
          "scale": scale,
          "paper_scale": {"n_gpus": 9600, "comm_shape": list(comm.shape),
                          "free_nodes": cluster.n_free, "policies": policies,
                          "rank_grid": {"shape": list(shape), "axes": list(axes),
                                        "spreads": spreads}}})
    return results


# ``benchmarks/bench_sim.py``'s and ``benchmarks/bench_faults.py``'s month
# workloads: 104 x 96 nodes, 30 days of Poisson jobs (seed 7) at a tick of
# 60 s; the fault month adds a 4096-node gpt-7b LPJ (TP 8, PP 8) arriving at
# 1 h and the fault trace of seed 13 at the fault model's default MTBFs.
SIM_PODS, SIM_NODES_PER_POD, SIM_DAYS, SIM_MAX_NODES = 104, 96, 30.0, 256
SIM_TICK_S, SIM_SEED = 60.0, 7
SIM_MONTH_JOBS, SIM_MONTH_UTIL = 100_000, 0.7
FAULT_MONTH_JOBS, FAULT_UTIL, FAULT_SEED = 20_000, 0.6, 13
FAULT_LPJ_NODES, FAULT_LPJ_ARRIVAL = 4096, 3600.0
# The replays' digests (``sim_checksum``/``fault_checksum``), held equal to
# the reference's live digests at the same workloads by
# tests/test_torch_simulator.py and tests/test_torch_faults.py.
SIM_MONTH_CHECKSUM = "25b267d7011a1c1545ea2f8e83d855a588fc217ecc7e6da11d1f197a27993889"
FAULT_ELASTIC_CHECKSUM = "eb95cc9c7170ce6edda8b46ebbe7631a58f1d7d3a7ac6a14c89c9ebdac6ac377"
FAULT_NEVER_CHECKSUM = "d00a1877a2a61504bbcfb88d9c88d64d76229b3fde6fa763f1a9a76fcce71be8"
# What produced each LPJ plan and re-plan of a replay, as ``RecordingScheduler``
# records it: (method, served_by, coarse method, fine methods).  None came
# from a solve cut by its time limit, so the digests above do not depend on
# the host's speed; the same tests hold these equal to the reference's.
SIM_PARITY_PLANS = [("greedy-proven-optimal", None, None, ())] * 5   # the plan, 4 re-plans
_HIER_COLD = ("hier", "hier", "greedy-proven-optimal", ("greedy-proven-optimal",) * 3)
FAULT_MONTH_PLANS = [_HIER_COLD, ("hier-warm", "hier", None, ())]     # the plan, 1 re-plan


class RecordingScheduler:
    """A scheduler that passes each request to ``inner`` and records what
    produced the result, so a replay can show that no solve in it stopped
    at its time limit."""

    def __init__(self, inner):
        self.inner, self.name, self.records = inner, inner.name, []

    def schedule(self, request):
        res = self.inner.schedule(request)
        self.records.append((res.method, res.stats.get("served_by"),
                             res.stats.get("coarse_method"),
                             tuple(res.stats.get("fine_methods", ()))))
        return res


def month_mean_duration(offered_nodes: float, mean_interarrival: float,
                        max_nodes: int = SIM_MAX_NODES) -> float:
    """The benches' mean job duration for an offered load of ``offered_nodes``
    busy nodes: arrival rate x E[2^U] x the lognormal's mean, in their order
    of operations."""
    mean_sz = np.mean(2.0 ** np.arange(int(np.log2(max_nodes)) + 1))
    return offered_nodes * mean_interarrival / (mean_sz * float(np.exp(0.5 * 0.8 ** 2)))


def sim_replay(core, n_pods, nodes_per_pod, n_jobs, t_end, mean_interarrival, mean_duration,
               max_nodes, legacy, lpj_plan=None, plan_at=0.0, failures=None):
    """``bench_sim._replay`` through the scheduling core ``core`` (the port's,
    or any package with its API): a fresh trace, cluster and "mip" policy.
    Returns the ``SimResult``, its wall seconds and the LPJ solves' records."""
    jobs = core.poisson_trace(n_jobs, mean_interarrival=mean_interarrival,
                              mean_duration=mean_duration, max_nodes=max_nodes, seed=SIM_SEED)
    sched = RecordingScheduler(core.get_scheduler("mip"))
    policy = core.QueuePolicy(core.Cluster.uniform(n_pods, nodes_per_pod), scheduler=sched)
    sim = core.TraceSimulator(policy, tick=SIM_TICK_S)
    t0 = time.perf_counter()
    res = sim.run(jobs, t_end=t_end, lpj_plan=lpj_plan, plan_at=plan_at, failures=failures,
                  legacy=legacy)
    return res, time.perf_counter() - t0, sched.records


def sim_checksum(res) -> str:
    """``bench_sim._checksum``: a digest over every field of a replay's
    ``SimResult``, floats at full precision."""
    h = hashlib.sha256()
    for p in res.series:
        h.update(repr((p.t, p.allocation_rate, p.retention_rate, p.queued)).encode())
    h.update(repr(sorted(res.queue_delays.items())).encode())
    h.update(repr((res.preempted_at_lpj, res.manual_preemptions, res.lpj_nodes,
                   res.failed_nodes, res.lpj_replans)).encode())
    return h.hexdigest()


def sim_month(core):
    """bench_sim's month: 100 000 jobs on 9984 nodes at offered load 0.7, the
    vectorized replay, JCT backfill on (no LPJ, so nothing is solved)."""
    t_end = SIM_DAYS * 86400.0
    mean_interarrival = t_end / SIM_MONTH_JOBS
    mean_duration = month_mean_duration(SIM_MONTH_UTIL * SIM_PODS * SIM_NODES_PER_POD,
                                        mean_interarrival)
    res, wall, _ = sim_replay(core, SIM_PODS, SIM_NODES_PER_POD, SIM_MONTH_JOBS, t_end,
                              mean_interarrival, mean_duration, SIM_MAX_NODES, legacy=False)
    return res, wall


def sim_parity(core, model_spec) -> dict:
    """bench_sim's parity trace: 150 jobs on 4 x 16 nodes, a 32-node LPJ
    planned at 500 s for 3000 s and eight node failures, through the
    vectorized and the legacy replay.  ``model_spec`` is the package's
    gpt-7b ``ModelSpec``."""
    comm = core.build_comm_matrix(core.JobSpec(n_gpus=32 * 8, tp=4, pp=4, model=model_spec))
    kw = dict(n_pods=4, nodes_per_pod=16, n_jobs=150, t_end=5000.0, mean_interarrival=40.0,
              mean_duration=700.0, max_nodes=16, lpj_plan=(comm, 3000.0, 0.3, "pp"),
              plan_at=500.0,
              failures=[(700.0 + 100.0 * i, n) for i, n in enumerate(range(0, 64, 9))])
    fast, fast_wall, fast_plans = sim_replay(core, legacy=False, **kw)
    slow, slow_wall, slow_plans = sim_replay(core, legacy=True, **kw)
    return {"fast": sim_checksum(fast), "legacy": sim_checksum(slow), "fast_s": fast_wall,
            "legacy_s": slow_wall, "replans": fast.lpj_replans,
            "plans": fast_plans, "legacy_plans": slow_plans}


def fault_replay(core, faults, repair: str, model_spec, n_pods: int = SIM_PODS,
                 nodes_per_pod: int = SIM_NODES_PER_POD, n_jobs: int = FAULT_MONTH_JOBS,
                 days: float = SIM_DAYS, lpj_nodes: int = FAULT_LPJ_NODES,
                 max_nodes: int = SIM_MAX_NODES, **fault_overrides):
    """``bench_faults._replay`` through ``core`` and ``faults`` (the port's
    packages, or any with their API), by default at its month workload, the
    LPJ planned on a fresh "hier,mip,topo-aware" chain, so no placement
    cache of an earlier replay is consulted.  Returns the ``SimResult``, its
    wall seconds, the fault trace's digest and the LPJ solves' records."""
    t_end = days * 86400.0
    mean_interarrival = t_end / n_jobs
    outside = n_pods * nodes_per_pod - lpj_nodes
    mean_duration = month_mean_duration(FAULT_UTIL * outside, mean_interarrival, max_nodes)
    jobs = core.poisson_trace(n_jobs, mean_interarrival=mean_interarrival,
                              mean_duration=mean_duration, max_nodes=max_nodes, seed=SIM_SEED)
    sched = RecordingScheduler(core.FallbackChain(core.HierarchicalScheduler(), "mip",
                                                  "topo-aware"))
    policy = core.QueuePolicy(core.Cluster.uniform(n_pods, nodes_per_pod), scheduler=sched,
                              use_jct=False)
    sim = core.TraceSimulator(policy, tick=SIM_TICK_S)
    comm = core.build_comm_matrix(core.JobSpec(n_gpus=lpj_nodes * 8, tp=8, pp=8,
                                               model=model_spec))
    fm = faults.FaultModel(seed=FAULT_SEED, **fault_overrides)
    t0 = time.perf_counter()
    res = sim.run(jobs, t_end=t_end, lpj_plan=(comm, FAULT_LPJ_ARRIVAL, 0.5, "pp"),
                  plan_at=0.0, faults=fm, repair=repair)
    wall = time.perf_counter() - t0
    digest = faults.trace_digest(fm.generate(policy.cluster.fabric, t_end))
    return res, wall, digest, sched.records


def fault_checksum(res, fault_digest: str) -> str:
    """``bench_faults._checksum``: a digest over the fault trace and every
    fault-side field of the ``SimResult``."""
    h = hashlib.sha256()
    h.update(fault_digest.encode())
    h.update(repr((
        res.goodput, res.effective_training_s, res.lost_work_s,
        res.repair_downtime_s, res.halted_s, sorted(res.repair_tiers.items()),
        res.n_faults, res.n_fault_recoveries, res.preemption_cascades,
        res.fault_killed_jobs, res.straggler_swaps, res.lpj_shrinks,
        res.lpj_grows, res.lpj_capacity_final, res.failed_nodes,
    )).encode())
    return h.hexdigest()


def _expect(got, want, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: {got!r}, expected {want!r}")


def simulate_phase(card: str, cpu: str, placed: dict) -> None:
    """Arnold's evaluation path on the card's host: (a) bench_sim's month
    replay; (b) its fast-versus-legacy parity trace; (c) bench_faults's
    fault month under the elastic repair ladder (twice) and with no repair;
    (d) the modelled step of the 9600-GPU job ``placement`` placed through
    each policy.  The recorded digests are read from ``BENCH_sim.json`` and
    ``BENCH_faults.json``; the month's own digest is pinned above."""
    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, "BENCH_sim.json")) as f:
        bench_sim = json.load(f)
    with open(os.path.join(ROOT, "BENCH_faults.json")) as f:
        bench_faults = json.load(f)
    model = ModelSpec(**PLACE_MODEL7B)

    # (a) the month
    month, month_wall = sim_month(core)
    _expect(len(month.queue_delays), SIM_MONTH_JOBS, "sim month: jobs started")
    _expect(len(month.series), bench_sim["metrics"]["series_points"], "sim month: series points")
    # mean_alloc is np.mean over the series, whose summation order is numpy's
    # own: numpy 2.3.5 on an Intel family 6 model 207 host rounds it one ulp
    # below BENCH_sim.json's value while the series is bit-identical.  The
    # recorded value is held against the exactly rounded sum, which no host
    # changes.
    rates = [p.allocation_rate for p in month.series]
    _expect(math.fsum(rates) / len(rates), bench_sim["metrics"]["mean_alloc"],
            "sim month: mean allocation (exactly rounded sum)")
    _expect(sim_checksum(month), SIM_MONTH_CHECKSUM, "sim month: checksum")

    # (b) fast against legacy
    parity = sim_parity(core, model)
    _expect(parity["fast"], parity["legacy"], "parity trace: fast against legacy")
    _expect(parity["fast"], bench_sim["parity"]["checksum_fast"], "parity trace: checksum")
    _expect(parity["plans"], SIM_PARITY_PLANS, "parity trace: LPJ solves (fast)")
    _expect(parity["legacy_plans"], SIM_PARITY_PLANS, "parity trace: LPJ solves (legacy)")

    # (c) the fault month
    runs = {}
    for key, repair in (("elastic", "elastic"), ("elastic_again", "elastic"),
                        ("never", "never")):
        res, wall, digest, plans = fault_replay(core, faults, repair, model)
        _expect(digest, bench_faults["parity"]["fault_trace_digest"], f"{key}: fault trace")
        _expect(plans, FAULT_MONTH_PLANS, f"{key}: LPJ solves")
        runs[key] = {"checksum": fault_checksum(res, digest), "goodput": res.goodput,
                     "repair_tiers": dict(sorted(res.repair_tiers.items())),
                     "n_faults": res.n_faults, "n_fault_recoveries": res.n_fault_recoveries,
                     "preemption_cascades": res.preemption_cascades,
                     "fault_killed_jobs": res.fault_killed_jobs,
                     "straggler_swaps": res.straggler_swaps, "halted_s": res.halted_s,
                     "lpj_replans": res.lpj_replans, "wall_s": wall}
    _expect(runs["elastic"]["checksum"], bench_faults["parity"]["checksum_elastic"],
            "fault month: elastic checksum")
    _expect(runs["elastic"]["checksum"], FAULT_ELASTIC_CHECKSUM, "fault month: elastic checksum")
    _expect(runs["elastic_again"]["checksum"], runs["elastic"]["checksum"],
            "fault month: a second elastic replay")
    _expect(runs["never"]["checksum"], FAULT_NEVER_CHECKSUM, "fault month: never checksum")
    if not runs["elastic"]["goodput"] > runs["never"]["goodput"]:
        raise AssertionError(f"elastic goodput {runs['elastic']['goodput']} <= never-repair "
                             f"{runs['never']['goodput']}")

    # (d) what each policy's placement does to a step
    steps = {}
    for name in PLACE_POLICIES:
        out = throughput_of_placement(placed[name].placement)
        if not (math.isfinite(out["tokens_per_s"]) and out["tokens_per_s"] > 0):
            raise AssertionError(f"{name}: modelled tokens/s {out['tokens_per_s']}")
        steps[name] = {**{k: v for k, v in out.items() if k != "breakdown"},
                       "breakdown": dataclasses.asdict(out["breakdown"])}
    emit({"phase": "simulate", "card": card, "host_cpu": cpu,
          "numpy": np.__version__,
          "sim_month": {"nodes": SIM_PODS * SIM_NODES_PER_POD, "jobs": SIM_MONTH_JOBS,
                        "days": SIM_DAYS, "series_points": len(month.series),
                        "mean_alloc_fsum": math.fsum(rates) / len(rates),
                        "mean_alloc": month.mean_alloc(),
                        "mean_alloc_recorded": bench_sim["metrics"]["mean_alloc"],
                        "checksum": sim_checksum(month),
                        "wall_s": month_wall, "jobs_per_s": SIM_MONTH_JOBS / month_wall},
          "parity": {k: v for k, v in parity.items() if not k.endswith("plans")},
          "lpj_solves": {"parity": parity["plans"], "fault_month": FAULT_MONTH_PLANS},
          "fault_month": {"nodes": SIM_PODS * SIM_NODES_PER_POD, "jobs": FAULT_MONTH_JOBS,
                          "lpj_nodes": FAULT_LPJ_NODES,
                          "fault_trace_digest": bench_faults["parity"]["fault_trace_digest"],
                          **runs},
          "modelled_step": {"n_gpus": 9600, "note": "network model of the paper's H800 "
                                                    "cluster, not a measurement of the card",
                            "policies": steps,
                            "hier_over_random_fit": steps["hier"]["tokens_per_s"]
                            / steps["random-fit"]["tokens_per_s"]},
          "phase_s": time.perf_counter() - t_phase})


def serve_phase(cfg, dev: torch.device, n_layers: int, phase: str = "serve"):
    """``cfg`` at full width and ``n_layers`` layers (bf16, random weights
    from a seed) serving 16 seeded Poisson requests through ``ServeEngine``;
    checks every result, the page allocator and the exact launches.  Returns
    the launches, the model and its parameters."""
    full_depth = cfg.n_layers
    if n_layers != cfg.n_layers:
        print(f"NOTE: {cfg.name}'s depth cut from {cfg.n_layers} to {n_layers} layers; "
              "widths unchanged", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, ModelOptions("bfloat16", "bfloat16"), dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine_cfg = EngineConfig(max_batch=8, page_size=16, n_pages=1024, max_blocks=128)
    load = LoadGenConfig(
        seed=0, n_requests=16, rate_rps=50.0,
        prompt_mix=LengthMixture(((128, 0.5), (512, 0.3), (1024, 0.2))),
        response_mix=LengthMixture(((32, 0.5), (64, 0.35), (128, 0.15))),
        vocab=cfg.vocab,
    )
    requests = generate_requests(load)
    engine = ServeEngine(model, params, engine_cfg)
    n_buckets = len({engine_cfg.prefill_bucket(len(r.prompt)) for r in requests})

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = engine.run(requests)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()

    if len(results) != len(requests):
        raise AssertionError(f"{len(results)} results for {len(requests)} requests")
    for res, req in zip(results, requests):
        ok = (res.request_id == req.request_id and res.finish_reason == "length"
              and len(res.tokens) == req.max_new_tokens
              and all(0 <= t < cfg.vocab for t in res.tokens))
        if not ok:
            raise AssertionError(f"request {req.request_id}: {res.finish_reason}, "
                                 f"{len(res.tokens)}/{req.max_new_tokens} tokens")
    engine.cache.allocator.assert_all_free()
    norms_per_forward = 2 * cfg.n_layers + 1
    # warm-up (outside the engine's clock): one decode step and one prefill per bucket
    expected = {
        "rmsnorm": norms_per_forward * (stats.prefills + stats.decode_steps + 1 + n_buckets),
        "flash_attention": cfg.n_layers * (stats.prefills + n_buckets),
        "ssd_chunk_scan": 0, "rmsnorm_bwd": 0, "flash_attention_bwd": 0, "ssd_chunk_scan_bwd": 0,
    }
    if counts != expected or stats.prefills != len(requests):
        raise AssertionError(f"launch counts {counts}, expected {expected}")

    report = ServeReport.from_run(results, stats)
    emit({
        "phase": phase, "model": cfg.name, "n_layers": cfg.n_layers, "full_depth": full_depth,
        "d_model": cfg.d_model, "params": cfg.param_count(),
        "active_params": cfg.active_param_count(), "dtype": "bfloat16",
        "engine": dataclasses.asdict(engine_cfg), "init_s": init_s, "wall_s_with_warmup": wall_s,
        "prefills": stats.prefills, "decode_steps": stats.decode_steps,
        "launches": counts, "launches_in_warmup": {
            "rmsnorm": norms_per_forward * (1 + n_buckets),
            "flash_attention": cfg.n_layers * n_buckets},
        "report": report.to_dict(),
        "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    return counts, model, params


# -------------------------------------------------------------------- zamba
def zamba_launches(cfg, forwards: int, decode_steps: int) -> dict[str, int]:
    """Launches of ``forwards`` forwards and ``decode_steps`` decode steps: per
    forward one SSD scan per Mamba2 layer and one flash attention per
    application of the shared block; RMSNorm once per Mamba2 layer, twice per
    shared block and once at the end, in both paths."""
    units = cfg.n_layers // cfg.attn_every
    return {"rmsnorm": (cfg.n_layers + 2 * units + 1) * (forwards + decode_steps),
            "flash_attention": units * forwards, "ssd_chunk_scan": cfg.n_layers * forwards,
            "rmsnorm_bwd": 0, "flash_attention_bwd": 0, "ssd_chunk_scan_bwd": 0}


def zamba_parity_phase(cfg, dev: torch.device, n_layers: int = 12, seq: int = 300,
                       seeds: tuple[int, ...] = (3, 4, 5, 6)) -> None:
    """zamba2-2.7b at full width and ``n_layers`` layers: a ``seq``-token forward
    (three chunks of 128, the last padded) through the kernels against the
    plain versions, in fp32 and bf16, for the weights and tokens of each seed;
    in fp32, for the first seed, also the teacher-forced decode over the same
    tokens, which has no kernel, against the forward."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    report = {"phase": "zamba_parity", "n_layers": n_layers, "seq": seq, "chunk": 128,
              "seeds": {}}
    for seed in seeds:
        report["seeds"][seed] = _zamba_parity_seed(cfg, dev, seq, seed, decode=seed == seeds[0])
    # the SSD scan's share of the bf16 reading: the scan alone through its kernel
    report["ssd_alone_bf16"] = {seed: r["bfloat16"]["each_kernel_alone"]["ssd_chunk_scan"]
                                for seed, r in report["seeds"].items()}
    emit(report)


def _zamba_parity_seed(cfg, dev: torch.device, seq: int, seed: int, decode: bool) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    master = build_model(cfg, ModelOptions("float32", "float32"), dev).init(gen)
    tokens = torch.randint(0, cfg.vocab, (1, seq), device=dev, generator=gen)
    report = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = build_model(cfg, ModelOptions(name, name), dev)
        params = cast(master, dtype)
        with torch.no_grad():
            ops.reset_launch_counts()
            through_kernels, _ = model.forward(params, {"tokens": tokens})
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            with plain_kernels():
                through_plain, _ = model.forward(params, {"tokens": tokens})
            torch.cuda.synchronize()
        if counts != zamba_launches(cfg, 1, 0) or ops.launch_counts() != counts:
            raise AssertionError(f"zamba_parity: the kernel run launched {counts}, expected "
                                 f"{zamba_launches(cfg, 1, 0)}; the plain run must launch none "
                                 f"({ops.launch_counts()})")
        got, want = through_kernels[0, :, :cfg.vocab].float(), through_plain[0, :, :cfg.vocab].float()
        diff = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tol = 1e-3 if dtype == torch.float32 else 2e-2 * scale
        finite = bool(torch.isfinite(got).all())
        report[name] = {"max_abs_logit_diff": diff, "tol": tol, "max_abs_logit": scale}
        if dtype == torch.bfloat16:
            # a reading, not a check: each kernel alone, the others plain.  A
            # 12-layer bf16 model amplifies a few flipped roundings to percents
            # of its largest logit; this shows whose roundings they are.
            alone = report[name]["each_kernel_alone"] = {}
            with torch.no_grad():
                for kernel in PLAIN:
                    with plain_kernels(keep=kernel):
                        logits, _ = model.forward(params, {"tokens": tokens})
                    alone[kernel] = (logits[0, :, :cfg.vocab].float() - want).abs().max().item()
        if not finite or not diff <= tol or through_kernels.shape != (1, seq, cfg.padded_vocab):
            raise AssertionError(f"zamba_parity {name}, seed {seed}: max abs logit diff {diff} "
                                 f"> {tol} (finite={finite}); {report[name]}")
        if dtype == torch.float32 and decode:
            # fp32 sums in another order and the chunked scan against the
            # recurrence: 1e-3 of the largest logit
            with torch.no_grad():
                cache = model.init_cache(1, seq)
                steps = []
                for t in range(seq):
                    logits, cache = model.decode_step(params, cache, tokens[:, t: t + 1])
                    steps.append(logits[0, 0, :cfg.vocab].float())
                decoded = torch.stack(steps)
            dec_diff = (decoded - got).abs().max().item()
            dec_tol = 1e-3 * scale
            if not dec_diff <= dec_tol or cache["index"] != seq:
                raise AssertionError(f"zamba_parity: teacher-forced decode differs from the "
                                     f"forward by {dec_diff} > {dec_tol}")
            report["decode_vs_forward"] = {"max_abs_logit_diff": dec_diff, "tol": dec_tol}
        del params, through_kernels, through_plain
    return report


def zamba_phase(cfg, dev: torch.device):
    """zamba2-2.7b at full width and depth, bf16, random weights: one forward
    over ZAMBA_SEQ tokens (``prefill_32k``'s sequence, its batch cut from 32
    to 1), then decode_step at batch 8.  Returns the launch counts, the model
    and its parameters."""
    return recurrent_serve_phase(cfg, dev, "zamba", ZAMBA_SEQ, zamba_launches,
                                 "prefill_32k's sequence, its batch cut from 32 to 1")


def recurrent_serve_phase(cfg, dev: torch.device, phase: str, seq: int, launches, note: str):
    """``cfg`` (zamba2-2.7b, xlstm-350m) at full width and depth, bf16, random
    weights: one forward over ``seq`` tokens at batch 1, then decode_step at
    batch 8 from a fresh cache (64 teacher-forced prompt tokens, 64 greedy);
    ``launches(cfg, forwards, decode_steps)``: the exact launches.  Returns the
    launch counts, the model and its parameters."""
    lanes, prompt_len, n_greedy = 8, 64, 64
    model = build_model(cfg, ModelOptions("bfloat16", "bfloat16"), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab, (1, seq), device=dev, generator=gen)
    prompt = torch.randint(0, cfg.vocab, (lanes, prompt_len), device=dev, generator=gen)
    with torch.no_grad():
        # warm-up outside the clocks and counts: a short forward and one step
        model.forward(params, {"tokens": tokens[:, :256]})
        model.decode_step(params, model.init_cache(lanes, 16), prompt[:, :1])
        torch.cuda.synchronize()

        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        fwd_counts = ops.launch_counts()
        fwd_ok = logits.shape == (1, seq, cfg.padded_vocab) and \
            bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        forward_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del logits

        cache = model.init_cache(lanes, seq)
        # zamba2's ring of shared-attention KV; the xLSTM's state is O(1)
        kv_len = {"kv_len": cache["kv"]["k"].shape[2]} if "kv" in cache else {}
        ops.reset_launch_counts()
        finite = torch.ones((), dtype=torch.bool, device=dev)
        generated = []
        t0 = time.perf_counter()
        for t in range(prompt_len + n_greedy):
            tok = prompt[:, t: t + 1] if t < prompt_len else generated[-1]
            logits, cache = model.decode_step(params, cache, tok)
            finite &= torch.isfinite(logits[..., :cfg.vocab]).all()
            if t >= prompt_len - 1:
                generated.append(logits[:, -1, :cfg.vocab].argmax(dim=-1, keepdim=True))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec_counts = ops.launch_counts()
    steps = prompt_len + n_greedy
    out = torch.cat(generated[:n_greedy], dim=1).cpu()
    if not fwd_ok or not bool(finite) or cache["index"] != steps or out.shape != (lanes, n_greedy) \
            or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{phase}: forward ok {fwd_ok}, decode logits finite "
                             f"{bool(finite)}, index {cache['index']}/{steps}, tokens "
                             f"{tuple(out.shape)}")
    if fwd_counts != launches(cfg, 1, 0) or dec_counts != launches(cfg, 0, steps):
        raise AssertionError(f"{phase} launch counts: forward {fwd_counts}, expected "
                             f"{launches(cfg, 1, 0)}; decode {dec_counts}, expected "
                             f"{launches(cfg, 0, steps)}")
    emit({
        "phase": phase, "model": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "dtype": "bfloat16", "init_s": init_s,
        "forward": {"tokens": seq, "batch": 1, "note": note,
                    "wall_s": forward_s, "tokens_per_s": seq / forward_s,
                    "peak_device_memory_gb": forward_peak_gb, "launches": fwd_counts},
        "decode": {"lanes": lanes, "teacher_forced": prompt_len, "greedy": n_greedy,
                   **kv_len, "ms_per_step": decode_s * 1e3 / steps,
                   "tokens_per_s": lanes * steps / decode_s, "launches": dec_counts},
        "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    return {k: fwd_counts[k] + dec_counts[k] for k in fwd_counts}, model, params


# -------------------------------------------------------------------- train
TRAIN_BATCH, TRAIN_SEQ = 4, 1024   # 4 x 1024 tokens a step
TRAIN_STEPS = 8
TRAIN_LR = 1e-4   # the WSD schedule's peak


def train_launches(cfg, remat: bool) -> dict[str, int]:
    """Launches of one dense-model train step: per forward RMSNorm twice a
    layer and once at the end, flash attention once a layer; remat runs each
    layer's forward again in the backward (the final norm is outside the
    checkpoints); each backward once per forward call it differentiates."""
    layers = cfg.n_layers
    return {"rmsnorm": (2 * layers + 1) + (2 * layers if remat else 0),
            "flash_attention": layers * (2 if remat else 1), "ssd_chunk_scan": 0,
            "rmsnorm_bwd": 2 * layers + 1, "flash_attention_bwd": layers, "ssd_chunk_scan_bwd": 0}


def zamba_train_launches(cfg, remat: bool) -> dict[str, int]:
    """Launches of one zamba2 train step: per forward RMSNorm once a Mamba2
    layer, twice per application of the shared block and once at the end, an
    SSD scan per Mamba2 layer and a flash attention per application; remat
    runs each Mamba2 layer's forward again in the backward (the shared block is
    not checkpointed, as in the reference); each backward once per forward
    call it differentiates."""
    layers, units = cfg.n_layers, cfg.n_layers // cfg.attn_every
    return {"rmsnorm": layers + 2 * units + 1 + (layers if remat else 0),
            "flash_attention": units, "ssd_chunk_scan": layers * (2 if remat else 1),
            "rmsnorm_bwd": layers + 2 * units + 1, "flash_attention_bwd": units,
            "ssd_chunk_scan_bwd": layers}


def train_shape(cfg) -> tuple[int, int]:
    """(sequences, tokens a sequence) of a train step: TRAIN_BATCH x
    TRAIN_SEQ; the xLSTM's XLSTM_TRAIN_SEQ tokens, Whisper's decoder context."""
    return TRAIN_BATCH, {"ssm": XLSTM_TRAIN_SEQ, "audio": WHISPER_SEQ}.get(cfg.family, TRAIN_SEQ)


def train_data(cfg, seed: int = 0) -> SyntheticDataset:
    """``train_shape(cfg)`` tokens a batch, and for a VLM its patch
    embeddings, for Whisper its N_FRAMES frame embeddings, from the same seed,
    as the launcher makes them."""
    b, s = train_shape(cfg)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = ((b, cfg.n_patches, cfg.d_model), "float32")
    if cfg.family == "audio":
        extra["frames"] = ((b, N_FRAMES, cfg.d_model), "float32")
    return SyntheticDataset(cfg.vocab, s, b, seed=seed, extra_specs=extra)


def train_parity_phase(cfg, dev: torch.device, n_layers: int = 4, phase: str = "train_parity",
                       launches=train_launches) -> None:
    """``cfg`` (minicpm-2b; zamba2-2.7b, qwen3-moe-235b-a22b and
    phi-3-vision-4.2b for the other ``*_train_parity`` phases) at full width
    and ``n_layers`` layers, fp32 masters: the loss and every parameter's
    gradient on one batch, through the kernels (``launches``: the exact
    launches expected) against autograd through the plain versions, in fp32
    and in bf16 compute.
    Rule, per leaf: ||g_kernels - g_plain|| <= rel ||g_plain|| (Frobenius),
    rel = 1e-4 in fp32 (sums in another order) and 5e-2 in bf16 (about 13
    units of bf16 rounding, 2^-8, for a gradient that passes a few dozen
    bf16 roundings); the loss within 1e-5 (fp32) and 1e-2 (bf16) of the plain
    one, relative.  A MoE's plain run takes the kernel run's routing choices
    (``pinned_routes``): a near-tie that a kernel's rounding flips would swap
    a token's experts and move whole expert gradients, which is no measure
    of the kernels; the share of choices the plain run would have made
    otherwise is reported, and must be 0 in fp32.  ce and aux are reported
    apart."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    batch = batch_to_device(train_data(cfg).batch(0), dev)
    report = {"phase": phase, "model": cfg.name, "n_layers": n_layers,
              "tokens": math.prod(train_shape(cfg)), "rule": {"float32": 1e-4, "bfloat16": 5e-2}}
    master = None
    for name, rel, loss_rel in (("float32", 1e-4, 1e-5), ("bfloat16", 5e-2, 1e-2)):
        model = build_model(cfg, ModelOptions("float32", name, remat=False), dev)
        if master is None:
            master = model.init(torch.Generator(device=dev).manual_seed(4))
        ops.reset_launch_counts()
        log, recording = recorded_routes()
        with recording:
            loss_k, metrics_k, grads = loss_and_grads(model, master, batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        got = [g.clone() for g in tree_leaves(grads)]
        flips, pinning = pinned_routes(log)
        with plain_kernels(), pinning:
            loss_p, metrics_p, grads = loss_and_grads(model, master, batch)
        torch.cuda.synchronize()
        want = tree_leaves(grads)
        if counts != launches(cfg, remat=False) or ops.launch_counts() != counts:
            raise AssertionError(f"{phase} {name}: the kernel run launched {counts}, expected "
                                 f"{launches(cfg, remat=False)}; the plain run must launch "
                                 f"none ({ops.launch_counts()})")
        rels = [((a - b).norm() / b.norm().clamp(min=1e-30)).item() for a, b in zip(got, want)]
        loss_diff = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        worst = max(range(len(rels)), key=lambda i: (not math.isfinite(rels[i]), rels[i]))
        report[name] = {"loss_kernels": loss_k.item(), "loss_plain": loss_p.item(),
                        "loss_rel_diff": loss_diff, "loss_rule": loss_rel,
                        "leaves": len(rels), "worst_leaf_rel_diff": rels[worst],
                        "worst_leaf": leaf_paths(master)[worst],
                        "median_leaf_rel_diff": sorted(rels)[len(rels) // 2],
                        "max_abs_grad_diff": max((a - b).abs().max().item() for a, b in zip(got, want))}
        for part in ("ce", "aux"):
            report[name][f"{part}_kernels"] = metrics_k[part].item()
            report[name][f"{part}_plain"] = metrics_p[part].item()
        if cfg.is_moe:
            n_routes = sum(i.numel() for i, _ in log)
            report[name]["route_flip_share_unpinned"] = sum(int(f) for f in flips) / n_routes
        flipped = cfg.is_moe and name == "float32" and report[name]["route_flip_share_unpinned"] > 0
        # every gradient finite on both sides: a NaN compares false with any rule
        finite = all(bool(torch.isfinite(g).all()) for g in got + list(want))
        report[name]["launches"] = counts
        if flipped or not (finite and all(r <= rel for r in rels) and loss_diff <= loss_rel):
            raise AssertionError(f"{phase} {name}: {report[name]} (finite={finite})")
        del got, want, grads
    emit(report)


def run_train_steps(model, dev: torch.device, steps: int, expected: dict) -> dict:
    """``steps`` steps of ``make_train_step`` for ``model`` (fp32 masters and
    AdamW state): ``SyntheticDataset(seed 0)`` batches of ``train_shape``
    tokens under the config's schedule (peak TRAIN_LR, 2 warm-up
    steps).  Checks finite, falling loss, the first step's cross-entropy
    within 0.5 of ln(vocab) (a MoE's loss adds 0.01 aux to it), a finite aux
    loss at every step, every gradient present and finite, and ``expected``,
    the exact launches of every step.  The xLSTM's loss must fall on each
    step's own batch (evaluated again after its update, outside the step's
    clock and launches) rather than from the first step's batch to the
    last's: from one batch to the next it moves more in a few steps than
    training does (PERF.md, PR 24)."""
    cfg = model.cfg
    own_batch = cfg.family == "ssm"
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = init_opt_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = train_data(cfg)
    step_fn = make_train_step(model, AdamWConfig(lr=get_schedule(cfg.lr_schedule, TRAIN_LR, 2, steps)))
    torch.cuda.reset_peak_memory_stats()
    history, totals = [], dict.fromkeys(expected, 0)
    prefetch = Prefetcher(data)
    try:
        for step in range(steps):
            _, batch = prefetch.next()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()   # waits for the step
            history.append({"step": step + 1, "loss": loss, "grad_norm": gnorm, "lr": metrics["lr"],
                            "ms": (time.perf_counter() - t0) * 1e3, "ce": metrics["ce"].item(),
                            "aux": metrics["aux"].item()})
            counts = ops.launch_counts()
            if counts != expected:
                raise AssertionError(f"{cfg.name} train step {step + 1}: launches {counts}, "
                                     f"expected {expected}")
            totals = {k: totals[k] + counts[k] for k in totals}
            if own_batch:
                with torch.no_grad():
                    after, _ = model.loss(params, batch_to_device(batch, dev))
                history[-1]["loss_after_update"] = after.item()
    finally:
        prefetch.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = tree_leaves(params)
    grads_ok = all(p.grad is not None for p in leaves) and \
        bool(torch.stack([torch.isfinite(p.grad).all() for p in leaves]).all())
    losses = [h["loss"] for h in history]
    first_ok = abs(history[0]["ce"] - math.log(cfg.vocab)) < 0.5
    if not (grads_ok and first_ok and all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                                          and math.isfinite(h["aux"]) for h in history)
            and (all(h["loss_after_update"] < h["loss"] for h in history) if own_batch
                 else losses[-1] < losses[0])):
        raise AssertionError(f"{cfg.name} train: grads present and finite {grads_ok}, first ce "
                             f"{history[0]['ce']} against ln(vocab) {math.log(cfg.vocab)}, "
                             f"history {history}")
    step_ms = sorted(h["ms"] for h in history[1:])[(steps - 1) // 2]
    return {"init_s": init_s, "history": history, "step_ms": step_ms, "peak_gb": peak_gb,
            "grads_ok": grads_ok, "totals": totals, "n_params": sum(t.numel() for t in leaves),
            "state": (model, params, opt_state, step_fn, data)}


def train_phase(cfg, dev: torch.device, steps: int = TRAIN_STEPS, phase: str = "train",
                full_depth: int | None = None):
    """``cfg`` (minicpm-2b; qwen3-moe-235b-a22b at MOE_TRAIN_LAYERS for
    ``moe_train``, phi-3-vision-4.2b for ``vlm_train``) at full width with the
    reference's defaults: bf16 compute, fp32 masters and AdamW state, remat;
    ``run_train_steps`` under its schedule.  Model FLOPs count a MoE's active
    parameters (top_k of n_experts, as ``active_param_count``) and a VLM's
    patch positions, which run through every layer.  Returns the launches of
    all steps, the model, parameters, optimizer state, step function and
    dataset."""
    model = build_model(cfg, ModelOptions("float32", "bfloat16", remat=True), dev)
    expected = train_launches(cfg, remat=True)
    run = run_train_steps(model, dev, steps, expected)
    step_ms = run["step_ms"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    seq = TRAIN_SEQ + cfg.n_patches                        # positions a sequence
    n = cfg.active_param_count()
    hd = cfg.resolved_head_dim
    attn_fwd = 4 * TRAIN_BATCH * cfg.n_heads * (seq * (seq + 1) // 2) * hd * cfg.n_layers
    prefix = 2 * TRAIN_BATCH * cfg.n_patches * cfg.d_model ** 2   # patch_proj's forward
    model_flops = 6 * n * TRAIN_BATCH * seq + 3 * attn_fwd + 3 * prefix   # forward + backward (2x)
    remat_flops = 2 * n * TRAIN_BATCH * seq + attn_fwd     # the layers' forward again
    emit({
        "phase": phase, "model": cfg.name, "n_layers": cfg.n_layers,
        "full_depth": full_depth or cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "active_params": n, "params_initialised": run["n_params"],
        "positions_a_sequence": seq, "param_dtype": "float32", "compute_dtype": "bfloat16",
        "remat": True,
        "schedule": {"name": cfg.lr_schedule, "peak_lr": TRAIN_LR, "warmup_steps": 2},
        "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": steps, "init_s": run["init_s"],
        "history": run["history"],
        "median_step_ms_after_first": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "model_tflops": model_flops / step_ms / 1e9,
        "model_tflops_with_remat": (model_flops + remat_flops) / step_ms / 1e9,
        "peak_device_memory_gb": run["peak_gb"], "launches_per_step": expected,
        "launches_per_step_note": "forward kernels count the remat recompute: rmsnorm "
                                  "(2L + 1) + 2L, flash_attention 2L; backward kernels "
                                  "rmsnorm_bwd 2L + 1, flash_attention_bwd L",
        "grads_present_and_finite": run["grads_ok"],
        **({"aux_history": [h["aux"] for h in run["history"]]} if cfg.is_moe else {}),
    })
    return run["totals"], *run["state"]


# ------------------------------------------------------------- parallelism
# The meshed steps on the card: a world of one (NCCL) over a (1, 1)
# ("data", "model") DeviceMesh -- one H100 holds one rank, and NCCL refuses two
# ranks on one device; the multi-rank logic runs on the host in mesh_host.
MESH_TRAIN_STEPS = 3
MESH_SERVE_STEPS, MESH_SERVE_LANES, MESH_SERVE_CACHE = 16, 8, 64


def world_of_one_mesh():
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64), mesh_dim_names=("data", "model"))


def profiled_step(step_fn, state: list, batch) -> dict:
    """One train step from ``state`` ([params, opt_state], updated in place)
    under torch.profiler, after one warm-up step: ``_profiled``'s report."""
    def step():
        state[0], state[1], metrics = step_fn(state[0], state[1], batch)
        return metrics["loss"].item()

    report = _profiled(step, 1)
    state.clear()
    return report


def mesh_train_phase(cfg, dev: torch.device, steps: int = MESH_TRAIN_STEPS) -> dict:
    """minicpm-2b at full width and depth, ``train``'s recipe (fp32 masters,
    bf16 compute, remat, 4 x 1024 tokens): ``steps`` steps of the meshed
    ``make_train_step`` on a world of one (NCCL, a (1, 1) DeviceMesh), then
    ``steps`` of the unmeshed one from the same init, the first run's state
    freed before the second starts; then one more step of each under
    torch.profiler (device-busy against wall).  Rules: the losses within 1e-4
    (the reference's own rule for its sharded step against one device), every
    leaf of the meshed state a DTensor whose local shard is the whole leaf,
    and the meshed step's launches those of ``train_launches(cfg, remat=True)``
    at every step: RMSNorm and flash attention, forward and backward, on the
    local shards."""
    model = build_model(cfg, ModelOptions("float32", "bfloat16", remat=True), dev)
    data = train_data(cfg)
    batches = [data.batch(i) for i in range(steps + 1)]
    expected = train_launches(cfg, remat=True)
    opt = AdamWConfig(lr=get_schedule(cfg.lr_schedule, TRAIN_LR, 2, steps))
    report = {"phase": "mesh_train", "model": cfg.name, "n_layers": cfg.n_layers,
              "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": steps, "world": 1, "backend": "nccl",
              "mesh": {"data": 1, "model": 1}, "launches_per_step": expected, "rule": 1e-4}
    totals = dict.fromkeys(expected, 0)
    with process_group("cuda"):
        import torch.distributed as dist

        report["backend"] = dist.get_backend()
        for name, mesh in (("meshed", world_of_one_mesh()), ("unmeshed", None)):
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            opt_state = init_opt_state(params)
            step_fn = make_train_step(model, opt, mesh=mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, ms = [], []
            for i in range(steps):
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                params, opt_state, metrics = step_fn(params, opt_state, batches[i])
                losses.append(metrics["loss"].item())
                ms.append((time.perf_counter() - t0) * 1e3)
                counts = ops.launch_counts()
                if counts != expected:
                    raise AssertionError(f"mesh_train {name} step {i + 1}: launches {counts}, "
                                         f"expected {expected}")
                if mesh is not None:
                    totals = {k: totals[k] + counts[k] for k in totals}
            if mesh is not None:
                local = [shd.is_dtensor(t) and t.to_local().device.type == dev.type
                         and t.to_local().shape == t.shape
                         for t in tree_leaves(params) + tree_leaves(opt_state["m"])]
                if not all(local):
                    raise AssertionError(f"mesh_train: {local.count(False)} of {len(local)} leaves "
                                         "are not whole local shards of cuda DTensors")
            report[name] = {"losses": losses, "step_ms": ms,
                            "median_step_ms_after_first": sorted(ms[1:])[(steps - 1) // 2],
                            "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                            "profiled_step": profiled_step(step_fn, [params, opt_state],
                                                           batches[steps])}
            del params, opt_state, step_fn, metrics
            gc.collect()
            torch.cuda.empty_cache()
            report[name]["device_gb_after_free"] = torch.cuda.memory_allocated() / 1e9
    diffs = [abs(a - b) for a, b in zip(report["meshed"]["losses"], report["unmeshed"]["losses"])]
    report["max_abs_loss_diff"] = max(diffs)
    if not (all(math.isfinite(x) for x in report["meshed"]["losses"]) and max(diffs) <= 1e-4):
        raise AssertionError(f"mesh_train: meshed losses {report['meshed']['losses']} against "
                             f"unmeshed {report['unmeshed']['losses']} (rule 1e-4)")
    with tempfile.TemporaryDirectory() as tmp:   # the launcher's world of one on the card
        t0 = time.perf_counter()
        report["launcher_rc"] = launch_train.main(
            ["--device", "cuda", "--devices", "1", "--mesh-shape", "1x1", "--steps", "16",
             "--log-every", "8", "--ckpt-every", "8", "--ckpt-dir", tmp])
        report["launcher_s"] = time.perf_counter() - t0
    if report["launcher_rc"] != 0:
        raise AssertionError(f"mesh_train: the meshed launcher returned {report['launcher_rc']}")
    m, u = report["meshed"], report["unmeshed"]
    report["dtensor_overhead"] = {
        "wall_ms": m["profiled_step"]["wall_ms"] - u["profiled_step"]["wall_ms"],
        "device_busy_ms": m["profiled_step"]["device_busy_ms"] - u["profiled_step"]["device_busy_ms"],
        "device_ops": m["profiled_step"]["device_ops"] - u["profiled_step"]["device_ops"]}
    emit(report)
    return totals


@torch.no_grad()
def mesh_serve_phase(cfg, dev: torch.device, n_layers: int, phase: str = "mesh_serve") -> dict:
    """``cfg`` (glm4-9b; zamba2-2.7b for ``mesh_serve_zamba``, xlstm-350m for
    ``mesh_serve_xlstm``) at full width and ``n_layers`` layers, bf16:
    MESH_SERVE_STEPS greedy decode steps at MESH_SERVE_LANES lanes through the
    unmeshed ``decode_step``, then through ``make_serve_step`` on a world of
    one with the cache laid out by ``cache_shardings`` (the same weights,
    wrapped; zamba2's ring cache and Mamba2 states, the xLSTM's states written
    back through each rank's shard).  Rules: the same tokens at every step,
    the logits within the ``parity`` phase's bf16 rule (2e-2 of the largest
    |logit|), the same launches."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, ModelOptions(), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(5))
    gen = torch.Generator(device=dev).manual_seed(6)
    first = torch.randint(0, cfg.vocab, (MESH_SERVE_LANES, 1), device=dev, generator=gen,
                          dtype=torch.int32)

    def run(step_fn, p, cache):
        tokens, outs, chosen = first, [], []
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_SERVE_STEPS):
            logits, cache = step_fn(p, cache, tokens)
            # the real vocabulary: padding entries hold -1e30
            logits = shd.full_tensor(logits)[:, -1, :cfg.vocab].float()
            tokens = logits.argmax(-1, keepdim=True).to(torch.int32)
            outs.append(logits)
            chosen.append(tokens)
        torch.cuda.synchronize()
        return (torch.cat(chosen, 1), torch.stack(outs), ops.launch_counts(),
                (time.perf_counter() - t0) * 1e3 / MESH_SERVE_STEPS)

    tok_u, log_u, counts_u, ms_u = run(model.decode_step, params,
                                       model.init_cache(MESH_SERVE_LANES, MESH_SERVE_CACHE))
    with process_group("cuda"):
        mesh = world_of_one_mesh()
        step = make_serve_step(model, mesh)
        p, cache = step.lay_out(params, model.init_cache(MESH_SERVE_LANES, MESH_SERVE_CACHE))
        specs = {}
        shd.map_with_path(lambda path, t: specs.__setitem__(
            path, shd.from_placements(t.placements, mesh, t.ndim)) if shd.is_dtensor(t) else None,
            cache)
        tok_m, log_m, counts_m, ms_m = run(step, p, cache)
        del p, cache
    diff = (log_m - log_u).abs().max().item()
    scale = log_u.abs().max().item()
    same = torch.equal(tok_m, tok_u)
    report = {"phase": phase, "model": cfg.name, "n_layers": n_layers,
              "lanes": MESH_SERVE_LANES, "decode_steps": MESH_SERVE_STEPS,
              "cache_len": MESH_SERVE_CACHE, "world": 1, "cache_specs": specs,
              "tokens_identical": same, "max_abs_logit_diff": diff, "tol": 2e-2 * scale,
              "launches": counts_m, "ms_per_step_meshed": ms_m, "ms_per_step_unmeshed": ms_u}
    if not (same and diff <= 2e-2 * scale and counts_m == counts_u and counts_m["rmsnorm"] > 0
            and torch.isfinite(log_m).all().item()):
        raise AssertionError(f"{phase}: {report} (unmeshed launches {counts_u})")
    emit(report)
    return counts_m


def host_world_inputs() -> dict:
    """``tests/torch_parallel_world.py``'s inputs made by the port: each
    reduced model's parameters from seed 0 in the reference's layout
    (``to_jax_layout``), the pipeline's and the compressed mean's inputs."""
    import torch_parallel_world as world

    def flat(prefix, tree, out, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(prefix, v, out, f"{path}{k}/")
            else:
                out[f"{prefix}|{path}{k}"] = v

    out = {}
    configs = [(a, get_config(a).reduced())
               for a in dict.fromkeys(world.TRAIN_ARCHS + world.DECODE_ARCHS)]
    for prefix, cfg in configs + [("decode", world.decode_config())]:
        model = build_model(cfg, ModelOptions("float32", "float32", remat=False), "cpu")
        flat(prefix, to_jax_layout(model.init(torch.Generator().manual_seed(0)), cfg), out)
    rng = np.random.default_rng(0)
    out["pp_W"] = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    out["pp_x"] = rng.standard_normal((8, 2, 16)).astype(np.float32)
    out["cc_x"] = rng.standard_normal((4, 64)).astype(np.float32)
    out["frames"] = rng.standard_normal(
        (world.DECODE_B, world.DECODE_FRAMES, get_config("whisper-tiny").reduced().d_model)
    ).astype(np.float32)
    return out


def mesh_host_phase(device_type: str = "cpu") -> None:
    """The CPU tests' 4-rank gloo world (``tests/torch_parallel_world.py``) on
    the card machine's host and its torch (with ``"cuda"``: the same world on
    NCCL, rank r on ``cuda:r``, the phase ``mesh_cards``, where the meshed
    train step must also launch each kernel as often as the unmeshed one, at
    least once): the meshed train step on a (2, 2)
    ("data", "model") mesh for reduced minicpm-2b, qwen3-moe-235b-a22b,
    zamba2-2.7b, glm4-9b and dbrx-132b (3 fp32 steps against the unmeshed
    step, 1e-4; every leaf a local shard of its spec's shape), the gathers of
    one remat step of minicpm-2b, zamba2-2.7b and dbrx-132b leaf by leaf
    (``expected_gathers``: each layer's ZeRO-3 leaves twice, in the forward
    and the recompute), the trainer's state of
    reduced glm4-9b made in its layout (bit for bit ``model.init`` gathered,
    its losses within 1e-6 of the whole-tree init's, a save's host copy on
    rank 0 alone, the restore bit for bit), the seq-sharded decode (1e-4 against
    the unsharded decode, the seq-sharded branch taken; with 2 KV heads the
    head-sharded decode), zamba2's, the xLSTM's, Whisper's and dbrx-132b's decodes (1e-4
    against their unmeshed decodes, every cache leaf in its
    ``cache_shardings`` layout after the steps), the GPipe pipeline
    (S = 4, m = 8: forward 1e-5 and gradient 1e-4 against the stages applied
    in turn, Eq. 13's bytes across a boundary), ``compressed_psum_mean``
    (fp16 1e-2, int8 5e-2 of the exact mean) and ``make_dp_grad_fn``.  The
    ranks are processes of their own; their process groups end with them."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import pickle

    import torch_parallel_world as world

    with tempfile.TemporaryDirectory() as tmp:
        inputs = host_world_inputs()
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        t0 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
        subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_parallel_world.py"),
                        os.path.join(tmp, "inputs.npz"), os.path.join(tmp, "world.pkl"),
                        device_type], check=True, env=env, cwd=ROOT, timeout=600)
        world_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "world.pkl"), "rb") as f:
            got = pickle.load(f)
    on_cards = device_type == "cuda"
    report = {"phase": "mesh_cards" if on_cards else "mesh_host", "world": 4,
              "backend": "nccl" if on_cards else "gloo", "world_s": world_s,
              "torch": torch.__version__}
    failures = []
    for key, case in got.items():
        if key.startswith("train|"):
            diff = max(abs(a - b) for a, b in zip(case["mesh"], case["plain"]))
            report[key] = {"max_abs_loss_diff": diff, "losses": case["mesh"],
                           "sharded_leaves": case["sharded_leaves"]}
            if not diff <= 1e-4 or case["wrong_layouts"] or case["sharded_leaves"] <= 20:
                failures.append((key, diff, case["wrong_layouts"][:3]))
            if on_cards:
                used = [k for k, c in case["plain_launches"].items() if c > 0]
                report[key]["launches"] = case["mesh_launches"]
                if case["mesh_launches"] != case["plain_launches"] or \
                        not {"rmsnorm", "rmsnorm_bwd"} <= set(used):
                    failures.append((key, case["mesh_launches"], case["plain_launches"]))
    for arch in world.GATHER_ARCHS:   # ZeRO-3 at use: each layer's leaves twice under remat
        case = got[f"gathers|{arch}"]
        diff = max(abs(a - b) for a, b in zip(case["mesh"], case["plain"]))
        report[f"gathers|{arch}"] = {"leaves_gathered": len(case["gathers"]),
                                     "gathers": sum(case["gathers"].values()),
                                     "max_abs_loss_diff": diff}
        if case["gathers"] != world.expected_gathers(case) or not diff <= 1e-4:
            failures.append((f"gathers|{arch}", case["gathers"]))
    tr = got["trainer"]   # reduced glm4-9b's state made laid out, trained, saved, restored
    report["trainer"] = {k: tr[k] for k in ("sharded_init", "whole_init", "host_copies_by_rank",
                                            "restored_step")}
    if tr["init_not_bitwise"] or tr["init_wrong_layouts"] or tr["moments_wrong"] or \
            not max(abs(a - b) for a, b in zip(tr["sharded_init"], tr["whole_init"])) <= 1e-6 or \
            tr["host_copies_by_rank"] != [tr["leaves"], 0, 0, 0] or \
            tr["restored_step"] != (3, 3) or tr["restore_not_bitwise"] or \
            tr["restore_wrong_layouts"]:
        failures.append(("trainer", tr))
    for key, seq in (("decode", True), ("decode_heads", False)):
        dec = got[key]
        report[key] = {"max_abs_logit_diff": float(np.abs(dec["mesh"] - dec["plain"]).max()),
                       "seq_sharded": dec["seq_sharded"], "cache_spec": dec["cache_spec"]}
        if not (dec["seq_sharded"] == seq and report[key]["max_abs_logit_diff"] <= 1e-4):
            failures.append((key, report[key]))
    for key in [f"decode|{a}" for a in world.DECODE_ARCHS] + ["decode_1x4|dbrx-132b"]:
        dec = got[key]   # zamba2's, the xLSTM's, Whisper's and dbrx's; dbrx's on (1, 4) too
        diff = float(np.abs(dec["mesh"] - dec["plain"]).max())
        report[key] = {"max_abs_logit_diff": diff, "wrong_layouts": dec["wrong_layouts"]}
        if not (diff <= 1e-4 and not dec["wrong_layouts"]):
            failures.append((key, report[key]))
    pp = got["pipeline"]
    W = torch.from_numpy(inputs["pp_W"]).requires_grad_(True)
    y = torch.from_numpy(inputs["pp_x"])
    for i in range(4):
        y = torch.tanh(y @ W[i])
    (y ** 2).sum().backward()
    crossed = pp["sent"][0].get(1, 0) + pp["sent"][1].get(0, 0)
    report["pipeline"] = {"fwd_err": float(np.abs(pp["y"] - y.detach().numpy()).max()),
                          "grad_err": float(np.abs(pp["grad"] - W.grad.numpy()).max()),
                          "boundary_bytes": crossed,
                          "eq13_bytes": pp_boundary_bytes(2, 1, 16, 8, bytes_per_el=4)}
    if not (report["pipeline"]["fwd_err"] <= 1e-5 and report["pipeline"]["grad_err"] <= 1e-4
            and crossed == report["pipeline"]["eq13_bytes"]):
        failures.append(("pipeline", report["pipeline"]))
    cc = got["collectives"]
    report["collectives"] = {s: float(np.abs(cc[s] - cc["exact"]).max()) for s in ("fp16", "int8")}
    report["collectives"]["dp_grad"] = cc["dp"]
    if not (report["collectives"]["fp16"] < 1e-2 and report["collectives"]["int8"] < 5e-2
            and abs(cc["dp"][0] - cc["dp"][1]) < 1e-6 and cc["dp"][2] < 1e-3):
        failures.append(("collectives", report["collectives"]))
    if failures:
        raise AssertionError(f"{report['phase']}: {failures}")
    emit(report)


# ---------------------------------------- four cards: glm4-9b through the launcher
GLM4_CARDS_STEPS, GLM4_CARDS_BATCH = 8, 8
GLM4_CARDS_ARGV = ("--arch", "glm4-9b", "--full", "--devices", "4", "--mesh-shape", "2x2",
                   "--arnold", "--global-batch", str(GLM4_CARDS_BATCH), "--seq-len", str(TRAIN_SEQ),
                   "--lr", str(TRAIN_LR), "--log-every", "1", "--ckpt-every", str(GLM4_CARDS_STEPS))
GLM4_CARDS_LOSS_RULE = 1e-2      # step 1's loss against an unmeshed bf16 forward's
GLM4_CARDS_INIT_SLACK = 0.05     # a rank's peak before step 1 over its shards + the largest leaf,
                                 # and over the steps over the dry run's count of the cell
STEP_LINE = re.compile(r"^step\s+(\d+)\s+loss (\S+)\s+gnorm (\S+)\s+(\d+) ms$", re.M)
RANK_LINE = re.compile(r"rank (\d+) on (cuda:\d+): ")
#: NCCL's kernels by the collective kinds of ``launch.roofline.CollectiveBytes``
NCCL_KINDS = (("AllGather", "all-gather"), ("ReduceScatter", "reduce-scatter"),
              ("AllReduce", "all-reduce"))


def launcher_run(argv: list[str], timeout: float) -> dict:
    """``python -m repro_torch.launch.train`` with ``argv``, a process of its
    own whose ranks are its children: its exit code and seconds, the steps it
    logged, each rank's report (``rank R on cuda:I: {...}``) and its Arnold
    line.  Its lines other than the ranks' reports are printed as they are."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    out = proc.stdout
    for line in out.splitlines():
        print(f"  launcher: {line}", flush=True)
    ranks, decoder = {}, json.JSONDecoder()
    for m in RANK_LINE.finditer(out):   # a rank's report is one write, whole
        ranks[int(m[1])] = {"device": m[2], **decoder.raw_decode(out, m.end())[0]}
    arnold = re.search(r"^Arnold placement .*$", out, re.M)
    return {"rc": proc.returncode, "seconds": seconds, "stderr_tail": proc.stderr[-3000:],
            "steps": {int(m[1]): {"loss": float(m[2]), "grad_norm": float(m[3]), "ms": int(m[4])}
                      for m in STEP_LINE.finditer(out)},
            "ranks": ranks, "arnold": arnold[0] if arnold else None,
            "done": "done: first logged loss" in out}


def checkpoint_room(need: int) -> str:
    """A new directory with room for ``need`` bytes of checkpoints: in shared
    memory (``/dev/shm``) when the host's available memory holds them with
    64 GiB to spare for the ranks, else under the temporary directory or the
    checkout's ``build/`` where the file system has room.  Memory first: the
    checkpoints live only until the restart has read them, so they need not
    go through a disk."""
    import shutil

    free = {}
    spare = host_memory()["MemAvailable"] - 64 * 2**30
    for root in ("/dev/shm", tempfile.gettempdir(), os.path.join(ROOT, "build")):
        if root != "/dev/shm":
            os.makedirs(root, exist_ok=True)
        elif not os.path.isdir(root):
            continue
        free[root] = shutil.disk_usage(root).free
        if free[root] >= need and (root != "/dev/shm" or spare >= need):
            return tempfile.mkdtemp(prefix="glm4_ckpt_", dir=root)
    raise AssertionError(f"no room for two glm4-9b checkpoints ({need} B): free {free}, "
                         f"host memory to spare {spare}")


def host_memory() -> dict:
    """MemTotal and MemAvailable of the host, bytes."""
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return {k: int(info[k].split()[0]) * 1024 for k in ("MemTotal", "MemAvailable")}


def cards_dryrun_cell(arch: str = "glm4-9b", layers: int = 0) -> dict:
    """The dry run's count of a four-card train cell (``arch`` at full width,
    ``layers`` deep or its own depth; 8 x 1024 tokens, the launcher's recipe)
    on a (2, 2) fake world: rank 0's peak bytes, its arguments' bytes and the
    collectives' bytes by kind.  A host process: meta tensors, no card."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
    opts = ModelOptions(param_dtype="float32", compute_dtype="bfloat16", remat=True)
    t0 = time.perf_counter()
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        trace = dryrun._trace(cfg, ShapeSpec("cards", TRAIN_SEQ, GLM4_CARDS_BATCH, "train"),
                              mesh, opts, 1)
    return {"peak_bytes": trace.peak_bytes, "argument_bytes": trace.argument_bytes,
            "collective_bytes": trace.counts.bytes, "collective_calls": trace.counts.counts,
            "trace_s": time.perf_counter() - t0}


def glm4_step_rank(rank: int) -> dict | None:
    """One rank of the four-card world that measures glm4-9b's meshed step
    (the launcher's recipe, its state made laid out from seed 0, the naive
    (2, 2) mesh: on one host Arnold's order is the same): a warm-up step, a
    step under ``CollectiveBytes`` (bytes by kind, on every rank), one under
    torch.profiler on rank 0 (NCCL's kernels by kind, device ms), one timed
    alone and one with each ``DTensor.redistribute`` call timed on the host
    (``host_redistribute``: the ZeRO-3 gathers, shard to replica, apart from
    the rest).  Rank 0's report; None elsewhere."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import init_laid_out

    cfg = get_config("glm4-9b")
    dev = torch.device("cuda", rank)
    model = build_model(cfg, ModelOptions("float32", "bfloat16", remat=True), dev)
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR), mesh=mesh)
    params = init_laid_out(model, torch.Generator(dev).manual_seed(0),
                           lambda t: step.state_shardings(t)["params"])
    state = init_opt_state(params, step.state_shardings(params)["opt"]["m"])
    data = SyntheticDataset(cfg.vocab, TRAIN_SEQ, GLM4_CARDS_BATCH, seed=0)
    params, state, metrics = step(params, state, data.batch(0))
    float(metrics["loss"])
    counted = rf.CollectiveBytes()
    with counted:
        params, state, metrics = step(params, state, data.batch(1))
        float(metrics["loss"])
    torch.cuda.synchronize()
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if rank == 0
            else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, data.batch(2))
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    params, state, metrics = step(params, state, data.batch(3))
    float(metrics["loss"])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with host_redistribute() as host:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, data.batch(4))
        float(metrics["loss"])
        torch.cuda.synchronize()
        host["step_ms"] = (time.perf_counter() - t0) * 1e3
    if rank != 0:
        return None
    busy = 0.0
    nccl = {kind: {"ms": 0.0, "kernels": 0} for _, kind in NCCL_KINDS}
    other_nccl = 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time", None)
        ms = (evt.cuda_time if us is None else us) / 1e3
        busy += ms
        if "nccl" in evt.name.lower():
            kind = next((k for frag, k in NCCL_KINDS if frag in evt.name), None)
            if kind is None:
                other_nccl += ms
            else:
                nccl[kind]["ms"] += ms
                nccl[kind]["kernels"] += 1
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
            "unprofiled_ms": plain_ms, "host_redistribute": host,
            "nccl": nccl, "nccl_other_ms": other_nccl,
            "collective_bytes": counted.bytes, "collective_calls": counted.counts,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


@contextlib.contextmanager
def host_redistribute():
    """Under it each ``DTensor.redistribute`` call is timed on the host (the
    call's own time, until it returns: the dispatch of its collective, not
    the collective on the card).  Yields a dict that it fills at the end:
    ``gathers`` (calls that take some mesh dimension from a shard to a
    replica -- ZeRO-3's gathers at use) and ``others``, each {"calls", "ms"}."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    real, out = DTensor.redistribute, {}
    tally = {"gathers": [0, 0.0], "others": [0, 0.0]}

    def timed(self, *args, **kwargs):
        to = kwargs.get("placements", args[1] if len(args) > 1 else None) or self.placements
        kind = "gathers" if any(isinstance(a, Shard) and isinstance(b, Replicate)
                                for a, b in zip(self.placements, to)) else "others"
        t0 = time.perf_counter()
        try:
            return real(self, *args, **kwargs)
        finally:
            tally[kind][0] += 1
            tally[kind][1] += (time.perf_counter() - t0) * 1e3

    DTensor.redistribute = timed
    try:
        yield out
    finally:
        DTensor.redistribute = real
        out.update({k: {"calls": n, "ms": ms} for k, (n, ms) in tally.items()})


@torch.no_grad()
def glm4_unmeshed_loss(cfg) -> float:
    """glm4-9b's bf16 forward loss on one card (cuda:0), unmeshed: the
    launcher's init (fp32 masters from seed 0) and its first batch."""
    dev = torch.device("cuda", 0)
    model = build_model(cfg, ModelOptions("float32", "bfloat16", remat=False), dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    batch = batch_to_device(SyntheticDataset(cfg.vocab, TRAIN_SEQ, GLM4_CARDS_BATCH,
                                             seed=0).batch(0), dev)
    loss = float(model.loss(params, batch)[0])
    del params
    torch.cuda.empty_cache()
    return loss


def mesh_cards_glm4_phase(card: str) -> dict[str, int]:
    """glm4-9b at full width and depth (40 layers, d 4096, 32/2 heads of 128,
    vocab 151 552) trained through the launcher on the four cards' (2, 2)
    Arnold mesh: 8 steps (falling loss, rc 0, a checkpoint at step 8), then
    ``--steps 9`` on the same directory (step 8 restored into the layout, step
    9 logged); in both runs each rank's peak before its first step (the init,
    or the restore) at most its shards + the largest leaf + 5 %, its peak over
    the steps and the save at most the dry run's count of the cell + 5 %, its
    launches each step ``train_launches``'; step 1's loss within 1e-2 of an
    unmeshed bf16 forward's on one card (same init, same batch); then one step
    of a world of its own measured (``glm4_step_rank``) beside Eq. 1's volumes
    of the job and the dry run's count of the cell.  Returns the kernels'
    launches over every rank and step of both runs."""
    cfg = get_config("glm4-9b")
    opts = ModelOptions("float32", "bfloat16", remat=True)
    n = sum(t.numel() for t in tree_leaves(build_model(cfg, opts, "meta").init()))
    largest = 4 * cfg.padded_vocab * cfg.d_model
    state = 12 * n   # fp32 parameters, m and v
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    dry = subprocess.Popen(   # a host process beside the cards' work
        [sys.executable, "-c", "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.cards_dryrun_cell('glm4-9b')))"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    atexit.register(_stop, {"glm4_dryrun": dry})
    report = {"phase": "mesh_cards_glm4", "card": card, "parameters": n, "state_bytes": state,
              "largest_leaf_bytes": largest, "host_memory": host_memory()}
    ckpt = checkpoint_room(2 * state + 2 * 2**30)
    import shutil

    report["ckpt_free_bytes"] = shutil.disk_usage(ckpt).free
    try:
        first = launcher_run([*GLM4_CARDS_ARGV, "--steps", str(GLM4_CARDS_STEPS),
                              "--ckpt-dir", ckpt], 600)
        if first["rc"] != 0 or sorted(first["steps"]) != list(range(1, GLM4_CARDS_STEPS + 1)):
            raise AssertionError(f"mesh_cards_glm4: the launcher returned {first['rc']}, steps "
                                 f"{sorted(first['steps'])}: {first['stderr_tail']}")
        report["ckpt_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                   for d, _, fs in os.walk(ckpt) for f in fs)
        second = launcher_run([*GLM4_CARDS_ARGV, "--steps", str(GLM4_CARDS_STEPS + 1),
                               "--ckpt-dir", ckpt], 420)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    # one logged loss cannot fall: the launcher's rule returns 1 for the
    # restart, which must log step 9 alone and finish
    if sorted(second["steps"]) != [GLM4_CARDS_STEPS + 1] or not second["done"]:
        raise AssertionError(f"mesh_cards_glm4: the restart logged steps {sorted(second['steps'])} "
                             f"(rc {second['rc']}): {second['stderr_tail']}")
    t0 = time.perf_counter()
    from repro_torch.launch.mesh import spawn

    measured = spawn(glm4_step_rank, 4, "cuda")[0]
    measured["world_s"] = time.perf_counter() - t0
    unmeshed = glm4_unmeshed_loss(cfg)
    dry_out, _ = dry.communicate(timeout=600)
    if dry.returncode != 0:
        raise AssertionError(f"the glm4-9b dry-run cell failed ({dry.returncode})")
    _, job = launch_train.arnold_job(cfg, launch_train._parse(
        [*GLM4_CARDS_ARGV, "--steps", str(GLM4_CARDS_STEPS)]))
    job = build_comm_matrix(job)
    expected = train_launches(cfg, remat=True)
    dry_cell = json.loads(dry_out.strip().splitlines()[-1])
    failures = []
    for name, run in (("first", first), ("restart", second)):
        if sorted(run["ranks"]) != [0, 1, 2, 3]:
            failures.append((name, "rank reports", sorted(run["ranks"])))
            continue
        for r, rep in run["ranks"].items():
            steps = sum(n for n, _ in rep["launches"])
            if steps != len(run["steps"]) or any(c != expected for _, c in rep["launches"]):
                failures.append((name, r, "launches", rep["launches"][:2]))
            if rep["init_peak_bytes"] > \
                    (rep["state_bytes"] + largest) * (1 + GLM4_CARDS_INIT_SLACK):
                failures.append((name, r, "init peak", rep["init_peak_bytes"], rep["state_bytes"]))
            if rep["step_peak_bytes"] > dry_cell["peak_bytes"] * (1 + GLM4_CARDS_INIT_SLACK):
                failures.append((name, r, "step peak", rep["step_peak_bytes"],
                                 dry_cell["peak_bytes"]))
    losses = [first["steps"][s]["loss"] for s in sorted(first["steps"])]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        failures.append(("losses", losses))
    if not abs(losses[0] - unmeshed) <= GLM4_CARDS_LOSS_RULE:
        failures.append(("step 1 against the unmeshed forward", losses[0], unmeshed))
    if not (first["arnold"] or "").endswith("pods=1 spread(data axis)=1"):
        failures.append(("arnold", first["arnold"]))
    steps_ms = [first["steps"][s]["ms"] for s in sorted(first["steps"])][1:]
    report.update({
        "arnold": first["arnold"], "losses": losses, "restart_step": second["steps"],
        "unmeshed_bf16_loss": unmeshed, "step1_abs_diff": abs(losses[0] - unmeshed),
        "loss_rule": GLM4_CARDS_LOSS_RULE, "median_step_ms": float(np.median(steps_ms)),
        "tokens_per_s": GLM4_CARDS_BATCH * TRAIN_SEQ / (float(np.median(steps_ms)) / 1e3),
        "launcher_s": [first["seconds"], second["seconds"]], "launcher_rc": [first["rc"],
                                                                             second["rc"]],
        "ranks": {name: {r: {k: v for k, v in rep.items() if k != "launches"}
                         for r, rep in run["ranks"].items()}
                  for name, run in (("first", first), ("restart", second))},
        "launches_a_step": expected, "measured_step": measured,
        "eq1": {"v_w": job.v_w, "v_d": job.v_d, "v_p": job.v_p, "shape": list(job.shape)},
        "dryrun": dry_cell,
    })
    emit(report)
    if failures:
        raise AssertionError(f"mesh_cards_glm4: {failures}")
    runs = [rep["launches"] for run in (first, second) for rep in run["ranks"].values()]
    return {k: sum(n * c[k] for steps in runs for n, c in steps) for k in expected}


# ------------------------------------- four cards: dbrx-132b through the meshed steps
DBRX_CARDS_LANES, DBRX_CARDS_CACHE, DBRX_CARDS_SERVE_STEPS = 8, 512, 32
DBRX_CARDS_MESHES = ((1, 4), (2, 2))     # (data, model): EP/TP 4; TP/EP 2 with ZeRO-3 2
DBRX_CARDS_CHECK_LAYERS, DBRX_CARDS_CHECK_STEPS = 4, 16
DBRX_CARDS_TRAIN_LAYERS, DBRX_CARDS_TRAIN_STEPS = 5, 4
DBRX_CARDS_LOGIT_RULE = 2e-2      # x the largest |logit|: mesh_serve's and parity's bf16 rule
DBRX_CARDS_FP32_RULE = 1e-4       # x the largest |logit|: the meshes' step 1 in fp32 compute
# the meshes' step 1 in bf16, routes pinned: twice the gap read on 4 x H100 80GB
# HBM3 (0.1016 of a largest |logit| of 4.38, PERF.md); the two tensor-parallel
# orders round apart through 40 layers, past mesh_serve's 2e-2 of the largest
DBRX_CARDS_BF16_GAP = 2 * 0.1016
DBRX_CARDS_TOKEN_FLIPS = 16       # of the one-card check's 16 x 8 tokens (12.5 %)
DBRX_CARDS_LOSS_RULE = 1e-2       # step 1's loss against an unmeshed bf16 forward's
DBRX_CARDS_PEAK_SLACK = 0.05      # a rank's step peak over the dry run's count of the cell
CARD_BYTES = 80 * 2**30


def _peak(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _routes(mode):
    """(log, patch) for ``moe_route`` calls: ``"record"`` appends each call's
    choices to ``log`` (``recorded_routes``), a log pins each call to that
    log's choices and ``log`` gathers the flips (``pinned_routes``), None
    leaves the routes alone."""
    if mode is None:
        return [], contextlib.nullcontext()
    return recorded_routes() if mode == "record" else pinned_routes(mode)


@torch.no_grad()
def dbrx_decode(model, mesh, dev: torch.device, first: torch.Tensor, steps: int,
                forced: torch.Tensor | None = None, routes=None, again=None,
                every_logits: bool = False) -> dict:
    """``steps`` decode steps of ``model`` from seed 0's weights at
    DBRX_CARDS_LANES lanes from an empty cache of DBRX_CARDS_CACHE positions:
    through ``make_serve_step`` on ``mesh`` (the weights made laid out,
    ``init_laid_out``), or the unmeshed ``decode_step`` where ``mesh`` is None
    (the weights made whole).  Greedy from ``first``, or fed ``forced``'s
    tokens, the routes as ``routes`` says (``_routes``).  Each step's argmax
    over the real vocabulary, the logits (every step's with ``every_logits``,
    else step 1's), whether all were finite, the ms of each step, the rank's
    peak bytes while the weights are made and over the steps, the NCCL bytes
    of step 2 by kind (``CollectiveBytes``) and the kernels' launches; the
    routes' log.  ``again``: (routes, model of the same weights) pairs; for
    each, step 1 once more from an empty cache through that model on
    ``mesh``, its routes as ``routes`` says: its logits and routes' log
    (comparison only)."""
    from repro_torch.models.transformer import init_laid_out

    _reset_peak(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if mesh is None:
        step, params = model.decode_step, model.init(gen)
    else:
        step = make_serve_step(model, mesh)
        params = init_laid_out(model, gen, lambda t: shd.param_shardings(t, mesh))
    init_peak = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def run(m, step_fn, n, mode, counted=None):
        nonlocal params
        cache = m.init_cache(DBRX_CARDS_LANES, DBRX_CARDS_CACHE)
        if mesh is not None:
            params, cache = step_fn.lay_out(params, cache)
        tokens, chosen, logits_kept, ms, finite = first, [], [], [], True
        log, patch = _routes(mode)
        with patch:
            for i in range(n):
                t0 = time.perf_counter()
                with counted if i == 1 and counted is not None else contextlib.nullcontext():
                    logits, cache = step_fn(params, cache, tokens)
                logits = shd.full_tensor(logits)[:, -1, :m.cfg.vocab].float()
                finite = finite and bool(torch.isfinite(logits).all())
                chosen.append(logits.argmax(-1, keepdim=True).to(torch.int32))
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0 or every_logits:
                    logits_kept.append(logits.cpu())
                tokens = chosen[-1] if forced is None else forced[:, i:i + 1]
        log = [tuple(t.cpu() for t in entry) if isinstance(entry, tuple) else int(entry)
               for entry in log]
        return torch.cat(chosen, 1).cpu(), torch.stack(logits_kept), finite, ms, log

    counted = rf.CollectiveBytes()
    ops.reset_launch_counts()
    tokens, logits, finite, ms, log = run(model, step, steps, routes, counted)
    out = {"tokens": tokens, "logits": logits, "finite": finite, "ms": ms,
           "init_peak_bytes": init_peak, "peak_bytes": _peak(dev),
           "launches": ops.launch_counts(), "collective_bytes": counted.bytes,
           "collective_calls": counted.counts, "routes": log}
    out["again"] = []
    for mode, other in again or ():
        _, logits, finite, _, log = run(other, make_serve_step(other, mesh), 1, mode)
        out["again"].append({"logits": logits[0], "finite": finite, "routes": log})
    del params
    _reset_peak(dev)
    return out


def dbrx_train(cfg, mesh, dev: torch.device, steps: int) -> dict:
    """``cfg``'s meshed train step on ``mesh``, the launcher's recipe (fp32
    masters made laid out from seed 0, bf16 compute, remat, 8 x 1024 tokens
    a step, peak lr 1e-4): each step's loss and ms, the kernels' launches of
    each step, the rank's peak before step 1 and over the steps, and step
    2's collective bytes by kind."""
    from repro_torch.models.transformer import init_laid_out

    model = build_model(cfg, ModelOptions("float32", "bfloat16", remat=True), dev)
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR), mesh=mesh)
    _reset_peak(dev)
    params = init_laid_out(model, torch.Generator(dev).manual_seed(0),
                           lambda t: step.state_shardings(t)["params"])
    state = init_opt_state(params, step.state_shardings(params)["opt"]["m"])
    init_peak = _peak(dev)
    data = SyntheticDataset(cfg.vocab, TRAIN_SEQ, GLM4_CARDS_BATCH, seed=0)
    losses, ms, launches, counted = [], [], [], rf.CollectiveBytes()
    for i in range(steps):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with counted if i == 1 else contextlib.nullcontext():
            params, state, metrics = step(params, state, data.batch(i))
            losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(ops.launch_counts())
    out = {"losses": losses, "ms": ms, "launches": launches, "init_peak_bytes": init_peak,
           "peak_bytes": _peak(dev), "collective_bytes": counted.bytes,
           "collective_calls": counted.counts}
    del params, state, metrics
    _reset_peak(dev)
    return out


@torch.no_grad()
def dbrx_unmeshed_loss(cfg, dev: torch.device) -> float:
    """The bf16 forward loss of ``cfg`` on one card, unmeshed: the weights of
    ``dbrx_train``'s init (seed 0) made in bf16 -- its fp32 masters as its
    forward casts them -- and its first batch."""
    model = build_model(cfg, ModelOptions("bfloat16", "bfloat16", remat=False), dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    batch = batch_to_device(SyntheticDataset(cfg.vocab, TRAIN_SEQ, GLM4_CARDS_BATCH,
                                             seed=0).batch(0), dev)
    loss = float(model.loss(params, batch)[0])
    del params
    _reset_peak(dev)
    return loss


def dbrx_cards_rank(rank: int, device_type: str = "cuda", reduced: bool = False) -> dict:
    """One rank of the four-card world of ``mesh_cards_dbrx`` (``reduced``: the
    reduced config, a rehearsal on 4 gloo ranks): the one-card check at
    DBRX_CARDS_CHECK_LAYERS (rank 0's unmeshed greedy decode, its routes
    recorded; then both meshes fed its tokens, their routes pinned to its
    routes), the greedy decode at full depth on both meshes, each followed by
    step 1 again in fp32 compute from the same bf16 weights and again in bf16
    ((1, 4)'s routes recorded, (2, 2)'s pinned to them), then
    rank 0's unmeshed bf16 forward loss and the meshed train step at
    DBRX_CARDS_TRAIN_LAYERS on (2, 2).  Each rank's report; the logits are
    rank 0's alone."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_config("dbrx-132b")
    cfg = cfg.reduced() if reduced else cfg
    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":   # fp32 products stay full fp32, as on one card
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(6)
    first = torch.randint(0, cfg.vocab, (DBRX_CARDS_LANES, 1), device=dev, generator=gen,
                          dtype=torch.int32)
    meshes = {shape: init_device_mesh(device_type, shape, mesh_dim_names=("data", "model"))
              for shape in DBRX_CARDS_MESHES}
    serve_opts = ModelOptions("bfloat16", "bfloat16", remat=False)
    out: dict = {"rank": rank, "device": str(dev), "check": {}, "serve": {}}
    on_dev = lambda log: [tuple(t.to(dev) for t in entry) for entry in log]  # noqa: E731

    def keep(run):   # the logits go back from rank 0 alone
        if rank:
            run["logits"] = None
            for again in run["again"]:
                again.pop("logits")
        return run

    check = build_model(dataclasses.replace(cfg, n_layers=DBRX_CARDS_CHECK_LAYERS), serve_opts, dev)
    shared = [None, None]
    if rank == 0:
        out["check"]["one_card"] = dbrx_decode(check, None, dev, first, DBRX_CARDS_CHECK_STEPS,
                                               routes="record", every_logits=True)
        shared = [out["check"]["one_card"]["tokens"], out["check"]["one_card"]["routes"]]
    dist.broadcast_object_list(shared, src=0)   # rank 0's tokens and routes feed each mesh
    forced, pinned = shared[0].to(dev), on_dev(shared[1])
    for shape, mesh in meshes.items():
        out["check"][shape] = keep(dbrx_decode(check, mesh, dev, first, DBRX_CARDS_CHECK_STEPS,
                                               forced, pinned, every_logits=True))
    del check
    serve = build_model(cfg, serve_opts, dev)
    serve32 = build_model(cfg, ModelOptions("bfloat16", "float32", remat=False), dev)
    step1_routes = ("record", "record")   # fp32 compute, bf16
    for shape, mesh in meshes.items():
        run = dbrx_decode(serve, mesh, dev, first, DBRX_CARDS_SERVE_STEPS,
                          again=tuple(zip(step1_routes, (serve32, serve))))
        if step1_routes[0] == "record":
            step1_routes = tuple(on_dev(a["routes"]) for a in run["again"])
        out["serve"][shape] = keep(run)
    del serve, serve32
    tcfg = dataclasses.replace(cfg, n_layers=DBRX_CARDS_TRAIN_LAYERS)
    if rank == 0:
        out["unmeshed_bf16_loss"] = dbrx_unmeshed_loss(tcfg, dev)
    dist.barrier()
    out["train"] = dbrx_train(tcfg, meshes[(2, 2)], dev, DBRX_CARDS_TRAIN_STEPS)
    return out


def mesh_cards_dbrx_phase(card: str) -> dict[str, int]:
    """dbrx-132b at its published widths (d 6144, 48 q / 8 kv heads of 128, 16
    experts of 10752, top-4, vocab 100 352) on the four cards through the
    meshed steps (``dbrx_cards_rank``'s world, NCCL): 32 greedy decode steps
    at 8 lanes of the 40-layer model on the (1, 4) mesh (EP and TP 4) and on
    (2, 2) (TP/EP 2, ZeRO-3 2: each layer's weights gathered at its use); at 4
    layers both meshes against rank 0's unmeshed decode of the same init; and
    4 train steps at 5 of 40 layers on (2, 2), the depth four cards hold.
    Rules: on every rank and mesh the same tokens and finite logits, peak
    under 80 GiB; step 1's logits of the two meshes at 40 layers in fp32
    compute from the same bf16 weights (routes pinned) within 1e-4 of the
    largest |logit|, and in bf16 (routes pinned) within DBRX_CARDS_BF16_GAP
    (more than 2e-2 of the largest: rounding through 40 layers; each mesh's
    own routes reported), and at 4 layers each mesh's bf16 logits
    against one card's within 2e-2 of the largest; at most
    DBRX_CARDS_TOKEN_FLIPS of the one card's 128 greedy tokens differ from a
    mesh's argmax fed the same tokens (bf16 routes flip); the decodes launch
    RMSNorm; the train steps' losses finite, step 1's within 1e-2 of the
    unmeshed bf16 forward's, each step's launches ``train_launches``', a
    rank's step peak at most the dry run's count of the cell + 5 % and under
    80 GiB, the NCCL bytes of a step by kind the dry run's to the byte.
    Returns the kernels' launches over every rank and run."""
    from repro_torch.launch.mesh import spawn

    cfg = get_config("dbrx-132b")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    dry = subprocess.Popen(   # a host process beside the cards' work
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
         f"chip_smoke.cards_dryrun_cell('dbrx-132b', {DBRX_CARDS_TRAIN_LAYERS})))"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    atexit.register(_stop, {"dbrx_dryrun": dry})
    t0 = time.perf_counter()
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"   # the ranks' allocator
    try:
        ranks = spawn(dbrx_cards_rank, 4, "cuda")
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    world_s = time.perf_counter() - t0
    dry_out, _ = dry.communicate(timeout=600)
    if dry.returncode != 0:
        raise AssertionError(f"the dbrx-132b dry-run cell failed ({dry.returncode})")
    report = {"phase": "mesh_cards_dbrx", "card": card, "world_s": world_s,
              "dryrun": json.loads(dry_out.strip().splitlines()[-1])}
    report.update(dbrx_cards_rules(cfg, ranks, report["dryrun"]))
    emit(report)
    if report["failures"]:
        raise AssertionError(f"mesh_cards_dbrx: {report['failures']}")
    return report["launches"]


def _logit_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, the rule's bound: 2e-2 of the largest |b|)."""
    return float((a - b).abs().max()), DBRX_CARDS_LOGIT_RULE * float(b.abs().max())


def _median_after_first(ms: list[float]) -> float:
    return float(np.median(ms[1:]))


def dbrx_cards_rules(cfg, ranks: list[dict], dry: dict | None, card_bytes: int = CARD_BYTES
                     ) -> dict:
    """``mesh_cards_dbrx``'s rules on its ranks' reports (``dry``: the dry
    run's count of the train cell, None to leave its rules out, as a rehearsal
    on the host does): the figures it reports and its failures."""
    failures = []
    rank0 = ranks[0]
    rep: dict = {"serve": {}, "check": {}}
    expected = train_launches(dataclasses.replace(cfg, n_layers=DBRX_CARDS_TRAIN_LAYERS),
                              remat=True)
    launches = dict.fromkeys(expected, 0)

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    for name, depth, runs in (("serve", cfg.n_layers, "serve"), ("check", DBRX_CARDS_CHECK_LAYERS,
                                                                   "check")):
        for shape in DBRX_CARDS_MESHES:
            per_rank = [r[runs][shape] for r in ranks]
            key = "x".join(map(str, shape))
            rep[name][key] = {
                "n_layers": depth, "median_step_ms": _median_after_first(per_rank[0]["ms"]),
                "init_peak_bytes": [r["init_peak_bytes"] for r in per_rank],
                "peak_bytes": [r["peak_bytes"] for r in per_rank],
                "collective_bytes_a_step": per_rank[0]["collective_bytes"],
                "collective_calls_a_step": per_rank[0]["collective_calls"],
                "launches": per_rank[0]["launches"]}
            for r in per_rank:
                add(r["launches"])
                if not torch.equal(r["tokens"], per_rank[0]["tokens"]) or not r["finite"] \
                        or max(r["peak_bytes"], r["init_peak_bytes"]) >= card_bytes \
                        or r["launches"].get("rmsnorm", 0) <= 0:
                    failures.append((name, key, "rank", r is per_rank[0], r["finite"],
                                     r["peak_bytes"], r["launches"]))
    # step 1 again on each mesh in fp32 compute and in bf16 from the same
    # bf16 weights, (2, 2)'s routes pinned to (1, 4)'s; the bf16 runs' own
    # step 1 (each mesh its own routes) reported
    (a, a16), (b, b16) = (rank0["serve"][s]["again"] for s in DBRX_CARDS_MESHES)
    diff = float((b["logits"] - a["logits"]).abs().max())
    tol = DBRX_CARDS_FP32_RULE * float(a["logits"].abs().max())
    pinned16 = float((b16["logits"] - a16["logits"]).abs().max())
    bf16, bf16_tol = _logit_diff(rank0["serve"][(2, 2)]["logits"][0],
                                 rank0["serve"][(1, 4)]["logits"][0])
    rep["serve"]["step1_logits_2x2_vs_1x4"] = {
        "fp32_compute_max_abs_diff": diff, "tol": tol,
        "routes": sum(i.numel() for i, _ in a["routes"]), "routes_2x2_would_flip": sum(b["routes"]),
        "bf16_pinned_max_abs_diff": pinned16, "bf16_pinned_limit": DBRX_CARDS_BF16_GAP,
        "bf16_routes_2x2_would_flip": sum(b16["routes"]),
        "bf16_own_routes_max_abs_diff": bf16, "bf16_rule": bf16_tol}
    if not (diff <= tol and a["finite"] and b["finite"]):
        failures.append(("serve: step 1's logits across the meshes", diff, tol))
    if not (pinned16 <= DBRX_CARDS_BF16_GAP and a16["finite"] and b16["finite"]):
        failures.append(("serve: step 1's bf16 logits across the meshes", pinned16,
                         DBRX_CARDS_BF16_GAP))
    one = rank0["check"]["one_card"]
    add(one["launches"])
    rep["check"]["one_card"] = {"median_step_ms": _median_after_first(one["ms"]),
                                "init_peak_bytes": one["init_peak_bytes"],
                                "peak_bytes": one["peak_bytes"],
                                "routes": sum(i.numel() for i, _ in one["routes"])}
    for shape in DBRX_CARDS_MESHES:   # fed the one card's tokens, pinned to its routes
        key = "x".join(map(str, shape))
        got = rank0["check"][shape]
        diff, tol = _logit_diff(got["logits"], one["logits"])
        step1, _ = _logit_diff(got["logits"][0], one["logits"][0])
        flips = int((got["tokens"] != one["tokens"]).sum())
        rep["check"][key].update({"max_abs_diff": diff, "step1_max_abs_diff": step1, "tol": tol,
                                  "routes_would_flip": sum(got["routes"]),
                                  "tokens_differing": flips, "tokens": one["tokens"].numel(),
                                  "tokens_differing_allowed": DBRX_CARDS_TOKEN_FLIPS})
        if not (diff <= tol and flips <= DBRX_CARDS_TOKEN_FLIPS):
            failures.append(("check at 4 layers", key, diff, tol, flips))
    train = [r["train"] for r in ranks]
    losses = train[0]["losses"]
    step_ms = _median_after_first(train[0]["ms"])
    tcfg = dataclasses.replace(cfg, n_layers=DBRX_CARDS_TRAIN_LAYERS)
    tokens = GLM4_CARDS_BATCH * TRAIN_SEQ
    attn_fwd = 4 * GLM4_CARDS_BATCH * cfg.n_heads * (TRAIN_SEQ * (TRAIN_SEQ + 1) // 2) * \
        cfg.resolved_head_dim * tcfg.n_layers
    model_flops = 6 * tcfg.active_param_count() * tokens + 3 * attn_fwd
    rep["train"] = {
        "n_layers": tcfg.n_layers, "full_depth": cfg.n_layers, "params": tcfg.param_count(),
        "active_params": tcfg.active_param_count(), "batch": [GLM4_CARDS_BATCH, TRAIN_SEQ],
        "losses": losses, "step_ms": train[0]["ms"], "median_step_ms_after_first": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3, "model_tflops": model_flops / step_ms / 1e9,
        "unmeshed_bf16_loss": rank0["unmeshed_bf16_loss"],
        "init_peak_bytes": [t["init_peak_bytes"] for t in train],
        "step_peak_bytes": [t["peak_bytes"] for t in train],
        "collective_bytes_a_step": [t["collective_bytes"] for t in train],
        "collective_calls_a_step": train[0]["collective_calls"], "launches_a_step": expected}
    step1 = abs(losses[0] - rank0["unmeshed_bf16_loss"])
    rep["train"]["step1_abs_diff"] = step1
    if not (all(math.isfinite(v) for v in losses) and step1 <= DBRX_CARDS_LOSS_RULE):
        failures.append(("train losses", losses, rank0["unmeshed_bf16_loss"]))
    for r, t in enumerate(train):
        for counts in t["launches"]:
            add(counts)
        if any(c != expected for c in t["launches"]) or t["peak_bytes"] >= card_bytes:
            failures.append(("train rank", r, t["launches"][:1], t["peak_bytes"]))
        if dry is not None and (t["peak_bytes"] > dry["peak_bytes"] * (1 + DBRX_CARDS_PEAK_SLACK)
                                or t["collective_bytes"] != dry["collective_bytes"]):
            failures.append(("train rank against the dry run", r, t["peak_bytes"],
                             t["collective_bytes"]))
    rep["launches"], rep["failures"] = launches, failures
    return rep


# ------------------------------------------- remat policy, roofline, dry run
SAVE_TP_STEPS = 3


def save_tp_launches(cfg) -> dict[str, int]:
    """Launches of one ``save_tp_outputs`` train step: ``train_launches(cfg,
    remat=True)``.  The policy saves each layer's attention and MLP outputs
    (products and, on a mesh, their all-reduce), while every kernel's output
    is still needed by a backward -- both norms' by the projections' weight
    gradients, flash attention's out and lse by its own backward and by wo's
    weight gradient -- so the recompute launches every kernel it launched
    under ``"full"``: no recompute of a kernel is saved."""
    return train_launches(cfg, remat=True)


def save_tp_phase(cfg, dev: torch.device, steps: int = SAVE_TP_STEPS) -> dict:
    """minicpm-2b, ``train``'s recipe (40 layers, 4 x 1024 tokens, bf16 on fp32
    masters, remat): ``steps`` steps under ``remat_policy="save_tp_outputs"``,
    then ``steps`` under ``"full"`` from the same init, each run's state freed
    before the next.  Rules: the losses equal (the kernels are
    deterministic and the recompute replays the same ops: bit for bit), the
    launches of every step ``save_tp_launches``.  Reports the median step ms
    and the peak memory of both, and what one more forward leaves held for its
    backward (the saved outputs: 2 x 40 x 4096 x 2304 x 2 B = 1.51 GB more
    predicted).  Returns the save_tp run's launches."""
    data = train_data(cfg)
    batches = [data.batch(i) for i in range(steps)]
    expected = save_tp_launches(cfg)
    opt = AdamWConfig(lr=get_schedule(cfg.lr_schedule, TRAIN_LR, 2, steps))
    report = {"phase": "save_tp", "model": cfg.name, "n_layers": cfg.n_layers,
              "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": steps, "launches_per_step": expected,
              "predicted_extra_gb": 2 * cfg.n_layers * TRAIN_BATCH * TRAIN_SEQ * cfg.d_model * 2 / 1e9}
    totals = dict.fromkeys(expected, 0)
    for policy in ("save_tp_outputs", "full"):
        model = build_model(cfg, ModelOptions("float32", "bfloat16", remat=True,
                                              remat_policy=policy), dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        opt_state = init_opt_state(params)
        step_fn = make_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(steps):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batches[i])
            losses.append(metrics["loss"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = ops.launch_counts()
            if counts != expected:
                raise AssertionError(f"save_tp {policy} step {i + 1}: launches {counts}, "
                                     f"expected {expected}")
            if policy == "save_tp_outputs":
                totals = {k: totals[k] + counts[k] for k in totals}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # a step's peak lies where the gradients and AdamW's temporaries live,
        # after the saved activations are freed: what one more forward leaves
        # held for its backward shows them
        held = torch.cuda.memory_allocated()
        graph = model.loss(params, batch_to_device(batches[0], dev))   # loss and metrics
        torch.cuda.synchronize()
        report[policy] = {"losses": losses, "step_ms": ms,
                          "median_step_ms_after_first": sorted(ms[1:])[(steps - 1) // 2],
                          "peak_device_memory_gb": peak_gb,
                          "held_for_backward_gb": (torch.cuda.memory_allocated() - held) / 1e9}
        del model, params, opt_state, step_fn, metrics, graph
        gc.collect()
        torch.cuda.empty_cache()
    save, full = report["save_tp_outputs"], report["full"]
    report["losses_bit_identical"] = save["losses"] == full["losses"]
    report["extra_peak_gb"] = save["peak_device_memory_gb"] - full["peak_device_memory_gb"]
    report["extra_held_for_backward_gb"] = (save["held_for_backward_gb"]
                                            - full["held_for_backward_gb"])
    if not (report["losses_bit_identical"] and all(math.isfinite(x) for x in save["losses"])):
        raise AssertionError(f"save_tp: losses {save['losses']} under save_tp_outputs against "
                             f"{full['losses']} under full")
    emit(report)
    return totals


@torch.no_grad()
def time_glm4_prefill_decode(model, params, dev: torch.device, lanes: int = 8,
                             prefill: int = 1024, cached: int = 512, cache_len: int = 1024,
                             repeats: int = 5) -> dict:
    """glm4-9b's (``serve``'s model's) median ms of a ``prefill``-token forward
    at batch 1 and of a dense decode step at ``lanes`` lanes with ``cached``
    tokens in a ``cache_len`` cache, after a warm-up of each: the times the
    ``roofline`` phase holds to their bounds."""
    gen = torch.Generator(device=dev).manual_seed(9)
    tokens = torch.randint(0, model.cfg.vocab, (1, prefill), device=dev, generator=gen)
    step_tokens = torch.randint(0, model.cfg.vocab, (lanes, 1), device=dev, generator=gen,
                                dtype=torch.int32)
    cache = model.init_cache(lanes, cache_len)

    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[repeats // 2]

    def decode():
        cache["index"] = cached
        model.decode_step(params, cache, step_tokens)

    return {"prefill_ms": median_ms(lambda: model.forward(params, {"tokens": tokens})),
            "decode_ms": median_ms(decode), "lanes": lanes, "prefill_tokens": prefill,
            "cached": cached, "cache_len": cache_len}


def meta_flops(run) -> int:
    """``FlopCounterMode``'s count of ``run()`` (on meta tensors)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        run()
    return counter.get_total_flops()


def roofline_phase(mcfg, cfg, zcfg, glm4_times: dict) -> None:
    """The port's ``Roofline`` (H100 constants, one chip) on the paths the
    smoke times: ``train``'s minicpm-2b step (4 x 1024 tokens, remat, bf16 on
    fp32 masters), glm4-9b's 1024-token prefill and 8-lane decode step
    (``time_glm4_prefill_decode``, after ``serve``) and ``zamba``'s 32k
    forward.  FLOPs from ``FlopCounterMode`` over the same call on meta
    tensors (the plain versions there: attention's full s x s products, so
    above the causal kernels' work; zamba2's at no unit and one, extended
    over its nine identical units), bytes from ``analytic_hbm_bytes`` with
    ``attn_impl="flash"`` (the decode's cache read once).  Prints each path's
    measured ms, ``bound_s``, ``dominant`` and measured / bound beside the
    phase's own ``model_tflops`` (which counts attention; not replaced).
    Reporting for the benchmark to come, not a limit."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import input_specs

    meta = torch.device("meta")
    paths = {}
    t0 = time.perf_counter()

    # minicpm-2b's train step
    spec = ShapeSpec("train_4x1024", TRAIN_SEQ, TRAIN_BATCH, "train")
    model = build_model(mcfg, ModelOptions("float32", "bfloat16", remat=True), meta)
    params = model.init()
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR))
    flops = meta_flops(lambda: step(params, init_opt_state(params), input_specs(mcfg, spec)))
    train = REPORTS["train"]
    paths["train"] = (mcfg, spec, flops, train["median_step_ms_after_first"], 0.0,
                      train["model_tflops"])
    # glm4-9b's prefill and decode step
    model = build_model(cfg, ModelOptions(), meta)
    params = model.init()
    spec = ShapeSpec("prefill_1024", glm4_times["prefill_tokens"], 1, "prefill")
    with torch.no_grad():
        flops = meta_flops(lambda: model.forward(params, input_specs(cfg, spec)))
    paths["prefill"] = (cfg, spec, flops, glm4_times["prefill_ms"], 0.0, None)
    spec = ShapeSpec("decode_8x1024", glm4_times["cache_len"], glm4_times["lanes"], "decode")
    cache = model.init_cache(glm4_times["lanes"], glm4_times["cache_len"])
    cache["index"] = glm4_times["cached"]
    with torch.no_grad():
        flops = meta_flops(lambda: model.decode_step(
            params, cache, torch.zeros((glm4_times["lanes"], 1), dtype=torch.int32, device=meta)))
    paths["decode"] = (cfg, spec, flops, glm4_times["decode_ms"], float(rf.tensor_bytes(cache)),
                       None)
    # zamba2-2.7b's 32k forward, counted without its units and with one (the
    # plain SSD scan on meta takes seconds a layer) and extended over the
    # identical units, as the dry run extends its counts
    spec = ShapeSpec("prefill_32k_b1", ZAMBA_SEQ, 1, "prefill")
    per_depth = {}
    for n in (0, zcfg.attn_every):
        c = dataclasses.replace(zcfg, n_layers=n)
        model = build_model(c, ModelOptions(), meta)
        params = model.init()
        with torch.no_grad():
            per_depth[n] = meta_flops(lambda: model.forward(params, input_specs(c, spec)))
    flops = per_depth[0] + (per_depth[zcfg.attn_every] - per_depth[0]) * (
        zcfg.n_layers // zcfg.attn_every)
    paths["zamba_forward"] = (zcfg, spec, flops, REPORTS["zamba"]["forward"]["wall_s"] * 1e3,
                              0.0, None)

    report = {"phase": "roofline", "chips": 1, "peak_flops": rf.PEAK_FLOPS, "hbm_bw": rf.HBM_BW,
              "count_s": time.perf_counter() - t0}
    for name, (c, spec, flops, ms, cache_bytes, model_tflops) in paths.items():
        rl = rf.Roofline(arch=c.name, shape=spec.name, mesh="one-chip", chips=1,
                         hlo_flops=float(flops), hlo_bytes=0.0, collective_bytes=0.0,
                         collectives={}, model_flops=rf.model_flops_for(c, spec),
                         analytic_bytes=rf.analytic_hbm_bytes(
                             c, spec, attn_impl="flash", remat=True, kv_cache_bytes=cache_bytes))
        report[name] = {"model": c.name, "shape": dataclasses.asdict(spec), "measured_ms": ms,
                        "counted_flops": flops, "analytic_bytes": rl.analytic_bytes,
                        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
                        "bound_s": rl.bound_s, "dominant": rl.dominant,
                        "measured_over_bound": ms / 1e3 / rl.bound_s,
                        "model_tflops": (model_tflops if model_tflops is not None
                                         else rl.model_flops / ms / 1e9)}
        if not (math.isfinite(ms) and ms > 0 and rl.bound_s > 0):
            raise AssertionError(f"roofline {name}: {report[name]}")
    emit(report)


#: the dry run's cells on the card machine's host: the reference test's cell,
#: the train step this smoke runs, and a MoE; run after the card's phases
DRYRUN_CELLS = (("whisper-tiny", "decode_32k"), ("minicpm-2b", "train_4k"),
                ("qwen3-moe-235b-a22b", "decode_32k"))


def start_dryrun() -> dict:
    """``python -m repro_torch.launch.dryrun`` for each of DRYRUN_CELLS on the
    single-pod mesh, each in a process of its own (a ``fake`` world of 256
    ranks cannot share a process with NCCL), all at once, no card visible;
    ``dryrun_phase`` collects them.  Started after the card's phases, so that
    no host-bound phase shares its cores with them."""
    out = tempfile.mkdtemp(prefix="dryrun_")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": ""}
    procs = {}
    atexit.register(_stop, procs)   # a phase that fails before dryrun_phase leaves none running
    for arch, shape in DRYRUN_CELLS:
        cell_dir = os.path.join(out, f"{arch}_{shape}")
        procs[(arch, shape)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", "single", "--out", cell_dir], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return {"dir": out, "procs": procs, "t0": time.perf_counter()}


def _stop(procs: dict) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ----------------------------------------------------------------- examples
def examples_phase() -> dict[str, int]:
    """The four examples (``repro_torch.examples``) on the card, as a user runs
    ``python -m repro_torch.examples.<name>``: each ``main()`` with its
    default device, its own asserts, and its last printed line (``OK``).
    Returns the launches of all four (the reduced models' fp32 trainings and
    serving go through the kernels)."""
    import io

    from repro_torch.examples import elastic_failover, quickstart, schedule_and_launch
    from repro_torch.examples import serve as serve_example

    report = {"phase": "examples"}
    totals = None
    for name, module in (("quickstart", quickstart), ("serve", serve_example),
                         ("schedule_and_launch", schedule_and_launch),
                         ("elastic_failover", elastic_failover)):
        printed = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            out = module.main()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        last = printed.getvalue().rstrip().splitlines()[-1]
        if not last.startswith("OK"):
            raise AssertionError(f"examples {name}: last line {last!r}")
        totals = counts if totals is None else {k: totals[k] + counts[k] for k in totals}
        report[name] = {"seconds": seconds, "last_line": last, "launches": counts, "result": out}
    emit(report)
    return totals


#: the dry run's mesh: (data, model) = (16, 16)
DRYRUN_MESH = {"data": 16, "model": 16}


def dryrun_reckoning(arch: str, shape_name: str, record: dict) -> dict:
    """A closed-form reckoning of a cell's peak bytes a device on
    DRYRUN_MESH, the terms the traced step holds at once (bytes, each term
    an upper estimate): the arguments (the record's local shards); every
    weight gathered whole over ``data`` for the step (its bytes over the
    ``model`` shards ``param_spec`` gives it, ZeRO-3's all-gather at use),
    and the receive buffer of the largest beside it;
    for a train step at one microbatch of b sequences of s tokens, the layer
    inputs remat keeps (L x b s d in bf16), one layer's recompute (the plain
    attention's backward holds four fp32 s x s products a head -- P, dP,
    dP - D, dS -- on the heads ``model`` splits, and a dozen d-wide and three
    ffn-wide fp32 rows a token), the fp32 logits and their gradient on the
    vocabulary's shard, and the fp32 gradients of the local shards; for a
    decode step, one layer's attention over its cache shard (K and V
    repeated to the query heads in bf16, K upcast to fp32 and made
    contiguous, three fp32 score rows) and the fp32 logits."""
    from repro_torch.configs import SHAPES

    cfg, shape = get_config(arch), SHAPES[shape_name]
    data, model = DRYRUN_MESH["data"], DRYRUN_MESH["model"]
    params = build_model(cfg, ModelOptions("bfloat16", "bfloat16"), "meta").init()

    def split(path, leaf, axes):
        spec = shd.param_spec(path, leaf.shape, DRYRUN_MESH)
        named = {a for part in spec for a in (part if isinstance(part, tuple) else (part,)) if a}
        return math.prod(DRYRUN_MESH[a] for a in named & set(axes))

    leaves = []
    shd.map_with_path(lambda path, leaf: leaves.append((path, leaf)), params)
    gathered = sum(t.numel() * t.element_size() / split(p, t, ("model",)) for p, t in leaves)
    terms = {"arguments": record["memory"]["argument_bytes_per_device"],
             "gathered_weights": gathered}
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    vocab = cfg.padded_vocab // model if cfg.padded_vocab % model == 0 else cfg.padded_vocab
    if shape.kind == "train":
        b = shape.global_batch // data // record["microbatches"]
        s, d = shape.seq_len, cfg.d_model
        heads = hq // model if hq % model == 0 else hq
        ffn = cfg.d_ff // model if cfg.d_ff % model == 0 else cfg.d_ff
        terms["layer_inputs_remat_keeps"] = cfg.n_layers * b * s * d * 2
        terms["one_layer_recompute"] = 4 * b * heads * s * s * 4 + b * s * (12 * d + 3 * ffn) * 4
        terms["logits_and_gradient"] = 2 * b * s * vocab * 4
        terms["gradients"] = sum(t.numel() * 4 / split(p, t, ("data", "model")) for p, t in leaves)
    else:
        lanes = shape.global_batch // data
        if hkv % model == 0:
            heads, slots = hq // model, shape.seq_len
        else:
            heads, slots = hq, shape.seq_len // model
        group = heads // (hkv // model if hkv % model == 0 else hkv)
        cache = lanes * slots * heads * hd
        terms["one_layer_attention"] = (2 * cache * 2 * (group > 1) + 2 * cache * 4
                                        + 3 * lanes * heads * slots * 4)
        terms["logits"] = lanes * vocab * 4
    # a leaf gathered along a dimension other than its first holds the
    # collective's receive buffer beside the gathered result while it is joined
    terms["gather_buffer"] = max(t.numel() * t.element_size() / split(p, t, ("model",))
                                 for p, t in leaves)
    terms["total"] = sum(terms.values())
    return terms


#: the cell the card runs for real beside its trace: minicpm-2b at full width
#: and 4 layers, train_4k's sequence, the one microbatch of 2 sequences that a
#: device of the single-pod mesh holds, the meshed step on a world of one
DRYRUN_REAL_LAYERS, DRYRUN_REAL_BATCH = 4, 2
#: |counted - allocated| <= this share of the allocator's peak (its 512-byte
#: rounding and the CUDA ops' internal workspaces)
DRYRUN_REAL_RULE = 0.03


def dryrun_real_cell(mcfg, dev: torch.device) -> dict:
    """The dry run's count of a cell against the card: the step traced on
    meta in a ``fake`` world of one (``dryrun._trace``, its peak above the
    arguments), then the same step on the card (``dryrun._cell_step`` on
    ``dev``, NCCL world of one) with the plain versions in place of the
    kernels' calls, as the trace takes them on meta (``cpu_branch_kernels``:
    the plain attention's s x s products, which the flash kernel never
    allocates): its peak above what
    was allocated before, ``max_memory_allocated`` after
    ``reset_peak_memory_stats``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(mcfg, n_layers=DRYRUN_REAL_LAYERS)
    shape = ShapeSpec("train_4k_one_device", 4096, DRYRUN_REAL_BATCH, "train")
    opts = dryrun.options_for(cfg.name, "train_4k")
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        trace = dryrun._trace(cfg, shape, mesh, opts, 1)
    counted = trace.peak_bytes - trace.argument_bytes
    with process_group("cuda"):
        args, step, arg_bytes = dryrun._cell_step(cfg, shape, world_of_one_mesh(), opts, 1,
                                                  device=dev)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with cpu_branch_kernels():
            out = step(*args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        allocated = torch.cuda.max_memory_allocated() - before
        loss = float(out[2]["loss"])
        del args, step, out
        gc.collect()
        torch.cuda.empty_cache()
    return {"model": cfg.name, "n_layers": cfg.n_layers, "batch": [DRYRUN_REAL_BATCH, 4096],
            "microbatches": 1, "attention": "plain (s x s scores), as the trace",
            "argument_bytes": trace.argument_bytes, "argument_bytes_on_card": arg_bytes,
            "counted_step_bytes": counted, "allocated_step_bytes": allocated,
            "rel_diff": abs(counted - allocated) / allocated, "rule": DRYRUN_REAL_RULE,
            "trace_s": trace.seconds, "step_s": seconds, "loss": loss}


def dryrun_phase(started: dict, mcfg, dev: torch.device) -> None:
    """Runs ``dryrun_real_cell`` while ``start_dryrun``'s processes run on the
    host, then waits for them and prints each record's status, chips, peak
    bytes per device (the port's own account, ``StepCounts``) beside its
    ``dryrun_reckoning``, and roofline terms.  Rules: the real cell's count
    within DRYRUN_REAL_RULE of the card's allocator; every process returns
    0, every record ``ok`` on 256 chips with positive collective bytes, and
    its peak at or above its arguments and at or below its reckoning."""
    import shutil

    report = {"phase": "dryrun", "mesh": "single", "cells": {}}
    failures = []
    try:
        real = dryrun_real_cell(mcfg, dev)
        report["real_cell"] = real
        if not real["rel_diff"] <= DRYRUN_REAL_RULE:
            failures.append(("real cell", real))
        for (arch, shape), proc in started["procs"].items():
            out, _ = proc.communicate(timeout=600)
            key = f"{arch} x {shape}"
            if proc.returncode != 0:
                failures.append((key, proc.returncode, out[-2000:]))
                continue
            with open(os.path.join(started["dir"], f"{arch}_{shape}", "dryrun.jsonl")) as f:
                rec = json.loads(f.readline())
            rl = rec.get("roofline", {})
            reckoning = dryrun_reckoning(arch, shape, rec)
            report["cells"][key] = {
                "status": rec["status"], "chips": rec.get("chips"), "trace_s": rec.get("trace_s"),
                "microbatches": rec.get("microbatches"), **rec.get("memory", {}),
                "reckoning": reckoning,
                **{k: rl.get(k) for k in ("hlo_flops", "collective_bytes", "collectives",
                                          "compute_s", "memory_s", "collective_s", "dominant",
                                          "useful_ratio")}}
            cell = report["cells"][key]
            peak = cell.get("peak_bytes_per_device") or 0
            within = cell.get("argument_bytes_per_device", 0) <= peak <= reckoning["total"]
            if not (cell["status"] == "ok" and cell["chips"] == 256 and within
                    and (cell["collective_bytes"] or 0) > 0):
                failures.append((key, cell))
    finally:
        _stop(started["procs"])
        shutil.rmtree(started["dir"], ignore_errors=True)
    report["wall_s"] = time.perf_counter() - started["t0"]
    if failures:
        raise AssertionError(f"dryrun: {failures}")
    emit(report)


def zamba_train_phase(cfg, dev: torch.device, steps: int = TRAIN_STEPS):
    """zamba2-2.7b at full width and depth (54 Mamba2 layers, the shared block
    applied 9 times): bf16 compute, fp32 masters and AdamW state, remat of each
    Mamba2 layer; ``run_train_steps`` under its cosine schedule.  Returns the
    launches of all steps, the model, parameters, optimizer state, step
    function and dataset."""
    model = build_model(cfg, ModelOptions("float32", "bfloat16", remat=True), dev)
    expected = zamba_train_launches(cfg, remat=True)
    run = run_train_steps(model, dev, steps, expected)
    step_ms = run["step_ms"]
    params = run["state"][1]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    units = cfg.n_layers // cfg.attn_every
    n = run["n_params"]
    shared = sum(t.numel() for t in tree_leaves(params["shared"]))
    applied = n + (units - 1) * shared                     # the shared block's weights, per use
    hd = cfg.resolved_head_dim
    attn_fwd = 4 * TRAIN_BATCH * cfg.n_heads * (TRAIN_SEQ * (TRAIN_SEQ + 1) // 2) * hd * units
    mamba = n - shared - 2 * cfg.padded_vocab * cfg.d_model
    model_flops = 6 * applied * tokens + 3 * attn_fwd      # forward + backward (2x)
    remat_flops = 2 * mamba * tokens                       # the Mamba2 layers' forward again
    emit({
        "phase": "zamba_train", "model": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": n, "params_config": cfg.param_count(),
        "param_dtype": "float32", "compute_dtype": "bfloat16", "remat": "each Mamba2 layer",
        "schedule": {"name": cfg.lr_schedule, "peak_lr": TRAIN_LR, "warmup_steps": 2},
        "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": steps, "init_s": run["init_s"],
        "history": run["history"],
        "median_step_ms_after_first": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "model_tflops": model_flops / step_ms / 1e9,
        "model_tflops_with_remat": (model_flops + remat_flops) / step_ms / 1e9,
        "model_flops_note": "6 x (parameters, the shared block's once per application) x "
                            "tokens + 3 x the causal attention's forward; the SSD scan's own "
                            "products are not counted",
        "peak_device_memory_gb": run["peak_gb"], "launches_per_step": expected,
        "launches_per_step_note": "forward kernels count the remat recompute: rmsnorm "
                                  "(L + 2U + 1) + L, ssd_chunk_scan 2L, flash_attention U; "
                                  "backward kernels rmsnorm_bwd L + 2U + 1, ssd_chunk_scan_bwd L, "
                                  "flash_attention_bwd U (L Mamba2 layers, U applications)",
        "grads_present_and_finite": run["grads_ok"],
    })
    return run["totals"], *run["state"]


def trainer_phase(cfg, dev: torch.device) -> None:
    """The reduced config on the card through the launcher (fp32 compute, as
    the reference's single-device run), and a Trainer with a FaultInjector
    restart against an uninterrupted one: the final checkpoints must be
    bit-identical."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = launch_train.main(["--device", "cuda", "--ckpt-dir", os.path.join(tmp, "launch"),
                                "--steps", "24", "--log-every", "8", "--ckpt-every", "12"])
        launch_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"launch.train.main returned {rc}")
        small = cfg.reduced()
        finals = []
        for name, fail_at in (("restarted", [5]), ("uninterrupted", [])):
            model = build_model(small, ModelOptions("float32", "float32", remat=False), dev)
            trainer = Trainer(model, SyntheticDataset(small.vocab, 16, 4), AdamWConfig(lr=3e-3),
                              os.path.join(tmp, name),
                              TrainerConfig(total_steps=8, ckpt_every=4, log_every=4),
                              FaultInjector(fail_at))
            trainer.run()
            restarts = sum(h.get("event") == "restart" for h in trainer.history)
            if restarts != len(fail_at):
                raise AssertionError(f"trainer {name}: {restarts} restarts, expected {len(fail_at)}")
            # the final checkpoint's files, leaf by leaf
            path = os.path.join(tmp, name, "step_8")
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)["leaves"]
            finals.append({k: np.load(os.path.join(path, v["file"])) for k, v in manifest.items()})
        a, b = finals
        same = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        if not same:
            raise AssertionError("trainer: the restarted run's final checkpoint differs from the "
                                 "uninterrupted run's")
        restarts = {key: launcher_restart(tmp, arch) for key, arch in (
            ("zamba2_launcher_restart", "zamba2-2.7b"),
            ("qwen3_moe_launcher_restart", "qwen3-moe-235b-a22b"),
            ("phi3_vision_launcher_restart", "phi-3-vision-4.2b"))}
    emit({"phase": "trainer", "launcher_rc": rc, "launcher_s": launch_s,
          "config": f"{small.name} reduced", "restart_bit_identical": same,
          "leaves_compared": len(a), **restarts})


def launcher_restart(tmp: str, arch: str, steps: int = 12, fail_at: int = 8) -> dict:
    """Reduced ``arch`` on the card through ``launch.train.main`` twice: once
    with a ``FaultInjector`` that fails step ``fail_at`` once (the ``Trainer``
    restores the last checkpoint, its template built under fake tensors by
    the model's ``init``), once uninterrupted; both return 0 and their final
    checkpoints agree bit for bit.  A MoE's dispatch and combine are held to
    determinism on the card here: their sums have a fixed order."""
    import repro_torch.train as train_pkg

    finals, rcs, restarts = [], [], []
    for name, faults in ((f"{arch}_restarted", [fail_at]), (f"{arch}_uninterrupted", [])):
        trainers = []

        def make(*args, **kwargs):
            trainers.append(Trainer(*args, fault_injector=FaultInjector(faults), **kwargs))
            return trainers[-1]

        path = os.path.join(tmp, name)
        with mock.patch.object(train_pkg, "Trainer", make):
            rcs.append(launch_train.main(["--arch", arch, "--device", "cuda",
                                          "--ckpt-dir", path, "--steps", str(steps),
                                          "--log-every", "4", "--ckpt-every", str(steps // 2)]))
        restarts.append(sum(h.get("event") == "restart" for h in trainers[0].history))
        with open(os.path.join(path, f"step_{steps}", "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        finals.append({k: np.load(os.path.join(path, f"step_{steps}", v["file"]))
                       for k, v in manifest.items()})
    a, b = finals
    same = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    if rcs != [0, 0] or restarts != [1, 0] or not same:
        raise AssertionError(f"{arch} launcher restart: rc {rcs}, restarts {restarts}, final "
                             f"checkpoints bit-identical {same}")
    return {"launcher_rcs": rcs, "restarts": restarts, "steps": steps, "failed_at": fail_at,
            "restart_bit_identical": same, "leaves_compared": len(a)}


# ----------------------------------------------------------- xlstm, whisper
def _no_launches() -> dict[str, int]:
    return dict.fromkeys(ops.launch_counts(), 0)


def xlstm_launches(cfg, forwards: int, decode_steps: int) -> dict[str, int]:
    """Launches of ``forwards`` forwards and ``decode_steps`` decode steps of
    the xLSTM: RMSNorm once a block and once at the end, in both paths; no
    other kernel (the recurrences are plain tensor code, the reference's
    ``lax.scan``)."""
    return {**_no_launches(), "rmsnorm": (cfg.n_layers + 1) * (forwards + decode_steps)}


def xlstm_train_launches(cfg, remat: bool) -> dict[str, int]:
    """Launches of one xLSTM train step: RMSNorm once a block and once at the
    end; remat runs each unit's blocks again in the backward (the final norm
    is outside the checkpoints; the recurrences' segment checkpoints hold no
    norm); the backward once per norm."""
    layers = cfg.n_layers
    return {**_no_launches(), "rmsnorm": layers + 1 + (layers if remat else 0),
            "rmsnorm_bwd": layers + 1}


def whisper_launches(cfg, forwards: int, prefills: int, decode_steps: int) -> dict[str, int]:
    """Launches of Whisper's forwards, ``prefill_cross`` calls and decode
    steps: the encoder (in both of the first two) RMSNorm twice a layer and
    once at the end, flash attention once a layer; the decoder's forward
    RMSNorm three times a layer and once at the end, flash attention twice a
    layer (causal self-attention, cross-attention); a decode step the
    decoder's norms, its attention plain tensor code."""
    enc, dec = cfg.n_encoder_layers, cfg.n_layers
    enc_norms, dec_norms = 2 * enc + 1, 3 * dec + 1
    return {**_no_launches(),
            "rmsnorm": (enc_norms + dec_norms) * forwards + enc_norms * prefills
            + dec_norms * decode_steps,
            "flash_attention": (enc + 2 * dec) * forwards + enc * prefills}


def whisper_train_launches(cfg, remat: bool) -> dict[str, int]:
    """Launches of one Whisper train step: the forward's (``whisper_launches``);
    remat runs each layer's again in the backward (the two final norms are
    outside the checkpoints); each backward once per forward call it
    differentiates."""
    enc, dec = cfg.n_encoder_layers, cfg.n_layers
    norms, flash = 2 * enc + 3 * dec + 2, enc + 2 * dec
    return {**_no_launches(), "rmsnorm": norms + (norms - 2 if remat else 0),
            "flash_attention": flash * (2 if remat else 1), "rmsnorm_bwd": norms,
            "flash_attention_bwd": flash}


def teacher_forced(model, params, batch: dict, steps: int) -> torch.Tensor:
    """The logits (b, steps, vocab) fp32 of ``steps`` decode steps fed
    ``batch["tokens"]``'s first positions, from a fresh cache (Whisper's
    cross K/V filled by ``prefill_cross`` from ``batch["frames"]`` first)."""
    b, s = batch["tokens"].shape
    cache = model.init_cache(b, s)
    if "frames" in batch:
        cache = model.prefill_cross(params, cache, batch["frames"])
    out = []
    for t in range(steps):
        logits, cache = model.decode_step(params, cache, batch["tokens"][:, t: t + 1])
        out.append(logits[:, 0, :model.cfg.vocab].float())
    return torch.stack(out, dim=1)


def model_parity(cfg, dev: torch.device, batch: dict, expected: dict, decode_steps: int,
                 seed: int) -> dict:
    """``cfg``'s forward on ``batch`` (weights from ``seed``) through the
    kernels (``expected``: the exact launches) against the plain versions, in
    fp32 and in bf16; in fp32 also ``decode_steps`` teacher-forced decode
    steps, which take the forward's own path only through RMSNorm (and
    Whisper's encoder), against the forward's first positions.  Rules as
    ``zamba_parity``'s: |logit diff| <= 1e-3 in fp32 and 2e-2 of the largest
    logit in bf16; the decode within 1e-3 of the largest logit."""
    master = build_model(cfg, ModelOptions("float32", "float32"), dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    report = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = build_model(cfg, ModelOptions(name, name), dev)
        params = cast(master, dtype)
        with torch.no_grad():
            ops.reset_launch_counts()
            through_kernels, _ = model.forward(params, batch)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            with plain_kernels():
                through_plain, _ = model.forward(params, batch)
            torch.cuda.synchronize()
        if counts != expected or ops.launch_counts() != counts:
            raise AssertionError(f"{cfg.name} parity: the kernel run launched {counts}, expected "
                                 f"{expected}; the plain run must launch none "
                                 f"({ops.launch_counts()})")
        got, want = through_kernels[..., :cfg.vocab].float(), through_plain[..., :cfg.vocab].float()
        diff = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tol = 1e-3 if dtype == torch.float32 else 2e-2 * scale
        finite = bool(torch.isfinite(got).all())
        report[name] = {"max_abs_logit_diff": diff, "tol": tol, "max_abs_logit": scale,
                        "launches": counts}
        if not finite or not diff <= tol or through_kernels.shape != (
                *batch["tokens"].shape, cfg.padded_vocab):
            raise AssertionError(f"{cfg.name} parity {name}: max abs logit diff {diff} > {tol} "
                                 f"(finite={finite})")
        if dtype == torch.float32 and decode_steps:
            with torch.no_grad():
                decoded = teacher_forced(model, params, batch, decode_steps)
            dec_diff = (decoded - got[:, :decode_steps]).abs().max().item()
            dec_tol = 1e-3 * scale
            if not dec_diff <= dec_tol:
                raise AssertionError(f"{cfg.name}: teacher-forced decode differs from the "
                                     f"forward by {dec_diff} > {dec_tol}")
            report["decode_vs_forward"] = {"steps": decode_steps, "max_abs_logit_diff": dec_diff,
                                           "tol": dec_tol}
        del params, through_kernels, through_plain
    return report


def xlstm_parity_phase(cfg, dev: torch.device, n_layers: int = XLSTM_PARITY_LAYERS,
                       seq: int = 256, decode_steps: int = 16) -> None:
    """xlstm-350m at full width and ``n_layers`` layers (one unit): a
    ``seq``-token forward at batch 2 (two 128-step segments), kernels against
    plain in fp32 and bf16, and the teacher-forced decode (``model_parity``)."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, seq), device=dev, generator=gen)}
    emit({"phase": "xlstm_parity", "n_layers": n_layers, "batch": 2, "seq": seq,
          **model_parity(cfg, dev, batch, xlstm_launches(cfg, 1, 0), decode_steps, seed=8)})


def xlstm_phase(cfg, dev: torch.device):
    """xlstm-350m served at full width and depth: ``recurrent_serve_phase``
    over XLSTM_SEQ tokens."""
    return recurrent_serve_phase(cfg, dev, "xlstm", XLSTM_SEQ, xlstm_launches,
                                 "eight 128-step segments at batch 1")


def whisper_parity_phase(cfg, dev: torch.device, decode_steps: int = 16) -> None:
    """whisper-tiny at full width and depth: a forward over N_FRAMES frames and
    WHISPER_SEQ tokens at batch 2, kernels against plain in fp32 and bf16,
    then ``prefill_cross`` and the teacher-forced decode (``model_parity``);
    the same with 24 frames (the launcher's count), which ``prefill_cross``
    puts in place of ``init_cache``'s 1500-frame cross K/V."""
    report = {"phase": "whisper_parity", "layers": [cfg.n_encoder_layers, cfg.n_layers],
              "batch": 2, "seq": WHISPER_SEQ}
    for frames in (N_FRAMES, 24):
        gen = torch.Generator(device=dev).manual_seed(frames)
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, WHISPER_SEQ), device=dev, generator=gen),
                 "frames": torch.randn((2, frames, cfg.d_model), device=dev, generator=gen)}
        report[f"frames_{frames}"] = model_parity(cfg, dev, batch, whisper_launches(cfg, 1, 0, 0),
                                                  decode_steps, seed=9)
    emit(report)


def whisper_phase(cfg, dev: torch.device):
    """whisper-tiny served at full width and depth (bf16, random weights from a
    seed): ``prefill_cross`` of 8 lanes of N_FRAMES frames, then 64
    teacher-forced and 64 greedy decode steps against a WHISPER_SEQ cache;
    checks the outputs and the exact launches.  Returns the launches, the
    model and its parameters."""
    lanes, prompt_len, n_greedy = 8, 64, 64
    model = build_model(cfg, ModelOptions("bfloat16", "bfloat16"), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = torch.randn((lanes, N_FRAMES, cfg.d_model), device=dev, generator=gen)
    prompt = torch.randint(0, cfg.vocab, (lanes, prompt_len), device=dev, generator=gen)
    with torch.no_grad():
        # warm-up outside the clocks and counts: one prefill and one step
        model.decode_step(params, model.prefill_cross(params, model.init_cache(lanes, 16), frames),
                          prompt[:, :1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        cache = model.prefill_cross(params, model.init_cache(lanes, WHISPER_SEQ), frames)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pre_counts = ops.launch_counts()
        cross_ok = cache["cross_k"].shape == (cfg.n_layers, lanes, N_FRAMES, cfg.n_kv_heads,
                                              cfg.resolved_head_dim) and \
            bool(torch.isfinite(cache["cross_k"]).all() & torch.isfinite(cache["cross_v"]).all())
        ops.reset_launch_counts()
        finite = torch.ones((), dtype=torch.bool, device=dev)
        generated = []
        t0 = time.perf_counter()
        for t in range(prompt_len + n_greedy):
            tok = prompt[:, t: t + 1] if t < prompt_len else generated[-1]
            logits, cache = model.decode_step(params, cache, tok)
            finite &= torch.isfinite(logits[..., :cfg.vocab]).all()
            if t >= prompt_len - 1:
                generated.append(logits[:, -1, :cfg.vocab].argmax(dim=-1, keepdim=True))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec_counts = ops.launch_counts()
    steps = prompt_len + n_greedy
    out = torch.cat(generated[:n_greedy], dim=1).cpu()
    if not cross_ok or not bool(finite) or cache["index"] != steps or \
            out.shape != (lanes, n_greedy) or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"whisper: cross K/V ok {cross_ok}, decode logits finite "
                             f"{bool(finite)}, index {cache['index']}/{steps}, tokens "
                             f"{tuple(out.shape)}")
    if pre_counts != whisper_launches(cfg, 0, 1, 0) or \
            dec_counts != whisper_launches(cfg, 0, 0, steps):
        raise AssertionError(f"whisper launch counts: prefill_cross {pre_counts}, expected "
                             f"{whisper_launches(cfg, 0, 1, 0)}; decode {dec_counts}, expected "
                             f"{whisper_launches(cfg, 0, 0, steps)}")
    emit({
        "phase": "whisper", "model": cfg.name, "layers": [cfg.n_encoder_layers, cfg.n_layers],
        "d_model": cfg.d_model, "params": sum(t.numel() for t in tree_leaves(params)),
        "dtype": "bfloat16", "init_s": init_s,
        "prefill_cross": {"lanes": lanes, "frames": N_FRAMES, "ms": prefill_ms,
                          "frames_per_s": lanes * N_FRAMES / prefill_ms * 1e3,
                          "launches": pre_counts},
        "decode": {"lanes": lanes, "max_len": WHISPER_SEQ, "teacher_forced": prompt_len,
                   "greedy": n_greedy, "ms_per_step": decode_s * 1e3 / steps,
                   "tokens_per_s": lanes * steps / decode_s, "launches": dec_counts},
        "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    return {k: pre_counts[k] + dec_counts[k] for k in pre_counts}, model, params


def family_train_phase(cfg, dev: torch.device, steps: int, phase: str, launches):
    """``cfg`` (xlstm-350m, whisper-tiny) at full width and depth: bf16
    compute, fp32 masters and AdamW state, remat (each xLSTM unit, each
    Whisper layer); ``run_train_steps`` under its schedule, ``launches``: the
    exact launches of a step (the xLSTM's loss judged on each step's own
    batch).  Reports step time, tokens/s (the decoder's tokens;
    Whisper's frames beside them), peak memory and the loss history.  Returns
    the launches of all steps, the model, parameters, optimizer state, step
    function and dataset."""
    model = build_model(cfg, ModelOptions("float32", "bfloat16", remat=True), dev)
    expected = launches(cfg, remat=True)
    run = run_train_steps(model, dev, steps, expected)
    b, s = train_shape(cfg)
    emit({
        "phase": phase, "model": cfg.name, "n_layers": cfg.n_layers,
        **({"n_encoder_layers": cfg.n_encoder_layers, "frames": N_FRAMES}
           if cfg.family == "audio" else {}),
        "d_model": cfg.d_model, "params": run["n_params"], "param_dtype": "float32",
        "compute_dtype": "bfloat16", "remat": True,
        "schedule": {"name": cfg.lr_schedule, "peak_lr": TRAIN_LR, "warmup_steps": 2},
        "batch": [b, s], "steps": steps, "init_s": run["init_s"], "history": run["history"],
        "median_step_ms_after_first": run["step_ms"], "tokens_per_s": b * s / run["step_ms"] * 1e3,
        "peak_device_memory_gb": run["peak_gb"], "launches_per_step": expected,
        "grads_present_and_finite": run["grads_ok"],
    })
    return run["totals"], *run["state"]


# ------------------------------------------------------------------ profile
# The MoE's pieces (models/layers.py), each traced as a profiler range of its
# name by ``_profiled(..., moe=True)``: routing, slot assignment, dispatch,
# the expert GEMMs and combine (forward, and the remat recompute), and the
# backward of the dispatch and combine gathers.
MOE_PIECES = ("moe_route", "moe_slots", "moe_dispatch", "moe_experts", "moe_combine")


def _moe_ranges(stack: contextlib.ExitStack) -> None:
    from torch.profiler import record_function

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    for name in MOE_PIECES:
        stack.enter_context(mock.patch.object(model_layers, name,
                                              ranged(name, getattr(model_layers, name))))
    gather = model_layers._GatherRows
    stack.enter_context(mock.patch.object(gather, "backward", staticmethod(
        ranged("moe_gather_bwd", gather.backward))))


def _profiled(fn, repeats: int, moe: bool = False) -> dict:
    """Run ``fn`` ``repeats`` times under torch.profiler: wall and device-busy
    milliseconds per repeat, kernels launched per repeat, heaviest kernels.
    ``moe``: also the device milliseconds under each of MOE_PIECES' ranges,
    and under autograd's BmmBackward0 (the expert GEMMs' backward, with the
    combine's small weighted sum)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        if moe:
            _moe_ranges(stack)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list[float]] = {}
    ranges = (*MOE_PIECES, "moe_gather_bwd")
    for evt in prof.events():
        # a range shows on the device's timeline too, as its span: not a kernel
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.name not in ranges:
            us = getattr(evt, "device_time", None)
            if us is None:
                us = evt.cuda_time
            entry = by_name.setdefault(evt.name, [0.0, 0])
            entry[0] += us / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    flash_ms = sum(ms for name, (ms, _) in by_name.items() if "flash_" in name)
    ssd_ms = sum(ms for name, (ms, _) in by_name.items() if "ssd_" in name)
    # the SSD backward's kernels (ssd_bwd_*) apart from the forward's, each by name
    ssd_bwd: dict[str, float] = {}
    for name, (ms, _) in by_name.items():
        if "ssd_bwd_" in name:
            short = re.search(r"ssd_bwd_\w+", name).group(0)
            ssd_bwd[short] = ssd_bwd.get(short, 0.0) + ms / repeats
    pieces = {}
    if moe:
        for evt in prof.events():
            name = "BmmBackward0" if "BmmBackward0" in evt.name else evt.name
            if name in (*ranges, "BmmBackward0") and \
                    evt.device_type == torch.autograd.DeviceType.CPU:
                us = getattr(evt, "device_time_total", None)
                us = evt.cuda_time_total if us is None else us
                pieces[name] = pieces.get(name, 0.0) + us / 1e3 / repeats
    return {
        **({"moe_pieces_ms": pieces, "moe_pieces_share": sum(pieces.values()) / busy_ms * repeats}
           if moe else {}),
        "wall_ms": wall_ms / repeats, "device_busy_ms": busy_ms / repeats,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "flash_kernels_ms": flash_ms / repeats, "flash_kernels_share": flash_ms / busy_ms,
        "ssd_kernels_ms": ssd_ms / repeats, "ssd_kernels_share": ssd_ms / busy_ms,
        "ssd_bwd_kernels_ms": sum(ssd_bwd.values()),
        "ssd_fwd_kernels_ms": ssd_ms / repeats - sum(ssd_bwd.values()),
        "ssd_bwd_kernels": ssd_bwd,
        "device_ops": sum(n for _, n in by_name.values()) / repeats,
        "top_kernels": [{"name": name[:80], "ms": ms / repeats, "calls": n / repeats}
                        for name, (ms, n) in top],
    }


@torch.no_grad()
def profile_phase(model, params, dev: torch.device, phase: str = "profile") -> None:
    """Where a decode step (8 lanes, 512 tokens cached each) and a 1024-token
    prefill spend their time: host wall clock against device-busy time.  The
    profiler itself slows the host, so the idle share is an upper estimate."""
    lanes, ps, max_blocks, cached = 8, 16, 128, 512
    blocks = cached // ps + 1
    pages = model.init_paged_cache(lanes * blocks, ps)
    table = torch.full((lanes, max_blocks), -1, dtype=torch.int32, device=dev)
    table[:, :blocks] = torch.arange(lanes * blocks, dtype=torch.int32, device=dev).view(lanes, blocks)
    lengths = torch.full((lanes,), cached, dtype=torch.int32, device=dev)
    tokens = torch.ones((lanes, 1), dtype=torch.int32, device=dev)
    active = torch.ones(lanes, dtype=torch.bool, device=dev)
    prompt = torch.ones((1, 1024), dtype=torch.int32, device=dev)
    prefill_table = torch.full((max_blocks,), -1, dtype=torch.int32, device=dev)

    def decode():
        logits, _ = model.decode_step_paged(params, pages, table, lengths, tokens, active)
        return torch.argmax(logits[:, -1], dim=-1).cpu()

    def prefill():
        logits, _ = model.prefill_paged(params, pages, prefill_table, 1024, prompt)
        return int(torch.argmax(logits[0, 1023]))

    moe = model.cfg.is_moe
    emit({"phase": phase, "model": model.cfg.name, "n_layers": model.cfg.n_layers,
          "decode_step_8_lanes_512_cached": _profiled(decode, 5, moe),
          "prefill_1024": _profiled(prefill, 2, moe)})


def profile_train_phase(model, params, opt_state, step_fn, data,
                        phase: str = "profile_train") -> None:
    """Where one full-depth train step spends its time (one warm-up step,
    then one traced)."""
    batch = data.batch(TRAIN_STEPS)
    state = [params, opt_state]

    def step():
        state[0], state[1], metrics = step_fn(state[0], state[1], batch)
        return metrics["loss"].item()

    emit({"phase": phase, "model": model.cfg.name, "n_layers": model.cfg.n_layers,
          "tokens": math.prod(train_shape(model.cfg)),
          "train_step": _profiled(step, 1, model.cfg.is_moe)})


def profile_fp32_step_phase(cfg, dev: torch.device, n_layers: int = 4) -> None:
    """Where one fp32-compute ``loss_and_grads`` of ``train_parity``'s model
    (full width, ``n_layers`` layers, 4 x 1024 tokens, no remat) spends its
    device time: the launcher's dtype, whose flash forward and backward run on
    the CUDA cores."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    batch = batch_to_device(SyntheticDataset(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0).batch(0), dev)
    model = build_model(cfg, ModelOptions("float32", "float32", remat=False), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(4))

    def step():
        loss, _, _ = loss_and_grads(model, params, batch)
        return loss.item()

    emit({"phase": "profile_fp32_step", "n_layers": n_layers, "tokens": TRAIN_BATCH * TRAIN_SEQ,
          "loss_and_grads": _profiled(step, 2)})


@torch.no_grad()
def profile_zamba_phase(model, params, dev: torch.device) -> None:
    """Where zamba2-2.7b's decode step (8 lanes, ring of 4096) and its
    32768-token forward spend their time, as ``profile_phase`` does for glm4."""
    lanes = 8
    cache = model.init_cache(lanes, ZAMBA_SEQ)
    tok = torch.ones((lanes, 1), dtype=torch.int32, device=dev)
    tokens = torch.ones((1, ZAMBA_SEQ), dtype=torch.int32, device=dev)

    def decode():
        logits, _ = model.decode_step(params, cache, tok)
        return logits[:, -1].argmax(dim=-1).cpu()

    def forward():
        logits, _ = model.forward(params, {"tokens": tokens})
        return int(logits[0, -1].argmax())

    emit({"phase": "profile_zamba", "n_layers": model.cfg.n_layers,
          "decode_step_8_lanes_kv_4096": _profiled(decode, 5),
          f"forward_{ZAMBA_SEQ}": _profiled(forward, 1)})


@torch.no_grad()
def profile_recurrent_phase(model, params, dev: torch.device, phase: str) -> None:
    """Where xlstm-350m's decode step (8 lanes) and its XLSTM_SEQ-token forward,
    or whisper-tiny's ``prefill_cross`` (8 lanes of N_FRAMES frames) and decode
    step (8 lanes, a WHISPER_SEQ-slot cache) spend their time, as ``profile_phase``
    does for glm4."""
    lanes = 8
    cfg = model.cfg
    tok = torch.ones((lanes, 1), dtype=torch.int32, device=dev)
    report = {"phase": phase, "model": cfg.name, "n_layers": cfg.n_layers}
    if cfg.family == "audio":
        frames = torch.randn((lanes, N_FRAMES, cfg.d_model), device=dev)
        cache = model.init_cache(lanes, WHISPER_SEQ)

        def prefill():
            return float(model.prefill_cross(params, cache, frames)["cross_k"][0, 0, 0, 0, 0])

        report[f"prefill_cross_8_lanes_{N_FRAMES}_frames"] = _profiled(prefill, 3)
        cache = model.prefill_cross(params, cache, frames)
    else:
        tokens = torch.ones((1, XLSTM_SEQ), dtype=torch.int32, device=dev)
        cache = model.init_cache(lanes, XLSTM_SEQ)

        def forward():
            logits, _ = model.forward(params, {"tokens": tokens})
            return int(logits[0, -1].argmax())

        report[f"forward_{XLSTM_SEQ}"] = _profiled(forward, 1)

    def decode():
        logits, _ = model.decode_step(params, cache, tok)
        return logits[:, -1].argmax(dim=-1).cpu()

    report["decode_step_8_lanes"] = _profiled(decode, 5)
    emit(report)


# --------------------------------------------------------------------- main
def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--layers", type=int, default=0,
                        help="depth of the serve phase (default: the model's own, 40)")
    parser.add_argument("--profile", action="store_true",
                        help="also trace a decode step and a prefill of each served model and "
                             "a train step with torch.profiler")
    parser.add_argument("--ptxas-info", action="store_true",
                        help="print each kernel's registers and shared memory from the build")
    parser.add_argument("--cards", type=int, default=1, choices=(1, 4),
                        help="4: instead of every phase, only mesh_host's world on NCCL over "
                             "4 cards (the phase mesh_cards), dbrx-132b served and trained "
                             "through the meshed steps (mesh_cards_dbrx), the launcher on them "
                             "and glm4-9b trained through it (mesh_cards_glm4)")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    # fp32 products stay full fp32 (the reference's fp32 tests are held to 1e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, cpu = nvidia_smi_line(), host_cpu_model()
    emit({"phase": "env", "card": card, "host_cpu": cpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    _build.build_all(("-Xptxas", "-v") if args.ptxas_info else ())
    build = {"phase": "build", "seconds": _build.build_seconds,
             "sources": [os.path.relpath(s, ROOT) for s in _build.sources()],
             "flags": list(_build.NVCC_FLAGS)}
    if args.ptxas_info:
        build["ptxas"] = ptxas_report(_build.compiler_output)
    emit(build)
    ignored = [stem for stem, text in _build.compiler_output.items() if "C7508" in text]
    if ignored:   # setmaxnreg ignored: the consumers would run on the producer's registers
        raise AssertionError(f"ptxas ignored setmaxnreg (C7508) in {ignored}")
    if args.cards == 4:
        if torch.cuda.device_count() < 4:
            raise SystemExit(f"--cards 4 needs 4 CUDA devices, found {torch.cuda.device_count()}")
        mesh_host_phase("cuda")
        mesh_cards_dbrx_phase(card)
        with tempfile.TemporaryDirectory() as tmp:   # the launcher's 4 NCCL ranks
            t0 = time.perf_counter()
            rc = launch_train.main(
                ["--device", "cuda", "--devices", "4", "--mesh-shape", "2x2", "--arnold",
                 "--scheduler", "mip", "--steps", "16", "--log-every", "8", "--ckpt-every", "8",
                 "--ckpt-dir", tmp])
            emit({"phase": "mesh_cards_launcher", "rc": rc, "seconds": time.perf_counter() - t0})
        if rc != 0:
            raise AssertionError(f"the launcher on 4 cards returned {rc}")
        mesh_cards_glm4_phase(card)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return

    cfg, zcfg, mcfg = get_config("glm4-9b"), get_config("zamba2-2.7b"), get_config("minicpm-2b")
    qcfg, vcfg = get_config("qwen3-moe-235b-a22b"), get_config("phi-3-vision-4.2b")
    xcfg, wcfg = get_config("xlstm-350m"), get_config("whisper-tiny")
    dcfg, pcfg, gcfg = get_config("dbrx-132b"), get_config("phi4-mini-3.8b"), get_config("granite-8b")
    cases = kernels_phase(cfg, zcfg, mcfg, qcfg, vcfg, xcfg, wcfg, dcfg, pcfg, gcfg, dev)
    torch.cuda.empty_cache()   # the 32k plain attention's graph pool
    parity_phase(cfg, dev)
    placed = placement_phase(card, cpu)
    simulate_phase(card, cpu, placed)
    del placed
    mesh_host_phase()
    serve_counts, model, params = serve_phase(cfg, dev, args.layers or cfg.n_layers)
    if args.profile:
        profile_phase(model, params, dev)
    glm4_times = time_glm4_prefill_decode(model, params, dev)
    del model, params
    torch.cuda.empty_cache()
    mesh_serve_counts = mesh_serve_phase(cfg, dev, args.layers or cfg.n_layers)
    torch.cuda.empty_cache()
    zamba_parity_phase(zcfg, dev)
    zamba_counts, model, params = zamba_phase(zcfg, dev)
    if args.profile:
        profile_zamba_phase(model, params, dev)
    del model, params
    torch.cuda.empty_cache()
    mesh_zamba_counts = mesh_serve_phase(zcfg, dev, zcfg.n_layers, "mesh_serve_zamba")
    torch.cuda.empty_cache()
    train_parity_phase(mcfg, dev)
    torch.cuda.empty_cache()
    if args.profile:
        profile_fp32_step_phase(mcfg, dev)
        torch.cuda.empty_cache()
    train_counts, *train_state = train_phase(mcfg, dev)
    if args.profile:
        profile_train_phase(*train_state)
    del train_state
    torch.cuda.empty_cache()
    save_tp_counts = save_tp_phase(mcfg, dev)
    torch.cuda.empty_cache()
    trainer_phase(mcfg, dev)
    torch.cuda.empty_cache()
    mesh_train_counts = mesh_train_phase(mcfg, dev)
    torch.cuda.empty_cache()
    train_parity_phase(zcfg, dev, 12, "zamba_train_parity", zamba_train_launches)
    torch.cuda.empty_cache()
    zamba_train_counts, *train_state = zamba_train_phase(zcfg, dev)
    if args.profile:
        profile_train_phase(*train_state, phase="profile_zamba_train")
    del train_state
    torch.cuda.empty_cache()
    moe_parity_phase(qcfg, dev)
    torch.cuda.empty_cache()
    moe_serve_counts, model, params = serve_phase(qcfg, dev, MOE_SERVE_LAYERS, "moe_serve")
    if args.profile:
        profile_phase(model, params, dev, phase="profile_moe")
    del model, params
    torch.cuda.empty_cache()
    print(f"NOTE: {qcfg.name}'s depth cut from {qcfg.n_layers} to {MOE_TRAIN_LAYERS} layer(s) "
          "for training; widths unchanged", flush=True)
    qcfg_train = dataclasses.replace(qcfg, n_layers=MOE_TRAIN_LAYERS)
    train_parity_phase(qcfg_train, dev, MOE_TRAIN_LAYERS, "moe_train_parity")
    torch.cuda.empty_cache()
    moe_train_counts, *train_state = train_phase(qcfg_train, dev, phase="moe_train",
                                                 full_depth=qcfg.n_layers)
    if args.profile:
        profile_train_phase(*train_state, phase="profile_moe_train")
    del train_state
    torch.cuda.empty_cache()
    moe_parity_phase(dcfg, dev, 2, "dbrx_parity")
    torch.cuda.empty_cache()
    dbrx_serve_counts, model, params = serve_phase(dcfg, dev, DBRX_SERVE_LAYERS, "dbrx_serve")
    del model, params
    torch.cuda.empty_cache()
    phi4_serve_counts, model, params = serve_phase(pcfg, dev, pcfg.n_layers, "phi4_serve")
    del model, params
    torch.cuda.empty_cache()
    train_parity_phase(pcfg, dev, 4, "phi4_train_parity")
    torch.cuda.empty_cache()
    # full depth fits: 71.2 GB of fp32 state (16 B x 4.45 G), its untied
    # 200 192-column head's logits and their gradient (2 x 3.28 GB) on top
    phi4_train_counts, *train_state = train_phase(pcfg, dev, phase="phi4_train")
    del train_state
    torch.cuda.empty_cache()
    granite_serve_counts, model, params = serve_phase(gcfg, dev, gcfg.n_layers, "granite_serve")
    del model, params
    torch.cuda.empty_cache()
    train_parity_phase(vcfg, dev, 4, "vlm_train_parity")
    torch.cuda.empty_cache()
    vlm_train_counts, *train_state = train_phase(vcfg, dev, phase="vlm_train")
    if args.profile:
        profile_train_phase(*train_state, phase="profile_vlm_train")
    del train_state
    torch.cuda.empty_cache()
    xlstm_parity_phase(xcfg, dev)
    xlstm_counts, model, params = xlstm_phase(xcfg, dev)
    if args.profile:
        profile_recurrent_phase(model, params, dev, "profile_xlstm")
    del model, params
    torch.cuda.empty_cache()
    mesh_xlstm_counts = mesh_serve_phase(xcfg, dev, xcfg.n_layers, "mesh_serve_xlstm")
    torch.cuda.empty_cache()
    print(f"NOTE: {xcfg.name}'s training sequence cut from train_4k's 4096 to "
          f"{XLSTM_TRAIN_SEQ} tokens (its recurrences run a step at a time on the host); "
          "widths and depth unchanged", flush=True)
    train_parity_phase(xcfg, dev, XLSTM_PARITY_LAYERS, "xlstm_train_parity", xlstm_train_launches)
    torch.cuda.empty_cache()
    xlstm_train_counts, *train_state = family_train_phase(
        xcfg, dev, XLSTM_TRAIN_STEPS, "xlstm_train", xlstm_train_launches)
    if args.profile:
        profile_train_phase(*train_state, phase="profile_xlstm_train")
    del train_state
    torch.cuda.empty_cache()
    whisper_parity_phase(wcfg, dev)
    whisper_counts, model, params = whisper_phase(wcfg, dev)
    if args.profile:
        profile_recurrent_phase(model, params, dev, "profile_whisper")
    del model, params
    torch.cuda.empty_cache()
    train_parity_phase(wcfg, dev, wcfg.n_layers, "whisper_train_parity", whisper_train_launches)
    torch.cuda.empty_cache()
    whisper_train_counts, *train_state = family_train_phase(
        wcfg, dev, TRAIN_STEPS, "whisper_train", whisper_train_launches)
    if args.profile:
        profile_train_phase(*train_state, phase="profile_whisper_train")
    del train_state
    torch.cuda.empty_cache()
    examples_counts = examples_phase()
    torch.cuda.empty_cache()
    dry = start_dryrun()   # host processes, beside the roofline phase's counting on meta
    roofline_phase(mcfg, cfg, zcfg, glm4_times)
    dryrun_phase(dry, mcfg, dev)
    # every kernel ran on a main path: the three forwards on zamba2's, rmsnorm
    # and flash attention on every serving (glm4's, qwen3-moe's, dbrx's,
    # phi4-mini's, granite's) and on every training (the examples' trainers
    # too), their backwards on every training, the SSD scan's forward and
    # backward on zamba2's training; rmsnorm and its backward on the xLSTM's
    # paths, both with flash attention and its backward on Whisper's (its
    # serving's flash in prefill_cross)
    trained = (train_counts, moe_train_counts, vlm_train_counts, mesh_train_counts, save_tp_counts,
               phi4_train_counts, examples_counts)
    served = (serve_counts, moe_serve_counts, dbrx_serve_counts, phi4_serve_counts,
              granite_serve_counts)
    if min(zamba_counts[k] for k in ("rmsnorm", "flash_attention", "ssd_chunk_scan")) <= 0 or \
            min(c[k] for c in served for k in ("rmsnorm", "flash_attention")) <= 0 or \
            min(c["rmsnorm"] for c in (mesh_serve_counts, mesh_zamba_counts, mesh_xlstm_counts)) <= 0 or \
            min(c[k] for c in trained for k in ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                                                "flash_attention_bwd")) <= 0 or \
            min(zamba_train_counts.values()) <= 0 or \
            min(xlstm_counts["rmsnorm"], xlstm_train_counts["rmsnorm"],
                xlstm_train_counts["rmsnorm_bwd"]) <= 0 or \
            min(whisper_counts[k] for k in ("rmsnorm", "flash_attention")) <= 0 or \
            min(whisper_train_counts[k] for k in ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                                                  "flash_attention_bwd")) <= 0:
        raise AssertionError(f"a main path never launched a kernel: serve {serve_counts}, "
                             f"zamba {zamba_counts}, train {train_counts}, "
                             f"zamba_train {zamba_train_counts}, moe_serve {moe_serve_counts}, "
                             f"moe_train {moe_train_counts}, vlm_train {vlm_train_counts}, "
                             f"xlstm {xlstm_counts}, xlstm_train {xlstm_train_counts}, "
                             f"whisper {whisper_counts}, whisper_train {whisper_train_counts}, "
                             f"mesh_train {mesh_train_counts}, mesh_serve {mesh_serve_counts}, "
                             f"mesh_serve_zamba {mesh_zamba_counts}, mesh_serve_xlstm "
                             f"{mesh_xlstm_counts}, save_tp {save_tp_counts}, dbrx_serve "
                             f"{dbrx_serve_counts}, phi4_serve {phi4_serve_counts}, granite_serve "
                             f"{granite_serve_counts}, phi4_train {phi4_train_counts}, examples "
                             f"{examples_counts}")
    paths = (serve_counts, zamba_counts, train_counts, zamba_train_counts, moe_serve_counts,
             moe_train_counts, vlm_train_counts, xlstm_counts, xlstm_train_counts,
             whisper_counts, whisper_train_counts, mesh_train_counts, mesh_serve_counts,
             mesh_zamba_counts, mesh_xlstm_counts, save_tp_counts, dbrx_serve_counts,
             phi4_serve_counts, phi4_train_counts, granite_serve_counts, examples_counts)

    def summary(name: str, source: str, replaces: str) -> dict:
        case = cases[name]
        return {
            "name": name, "route": "cuda", "plan_route": case.get("route", "cuda_cores"),
            "source": source, "replaces": replaces,
            "launches": sum(c[name] for c in paths),
            "max_abs_err": case["max_abs_err"],
            "ms": case["kernel_ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "shape": case.get("shape") or {"q": case["q"], "kv": case["kv"]},
            "dtype": case["dtype"],
            **({"segments": case["segments"]} if "segments" in case else {}),
        }

    emit({"kernels": [
        summary("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:23"),
        summary("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:69"),
        summary("ssd_chunk_scan", "src/repro_torch/kernels/csrc/ssd_chunk.cu",
                "src/repro/kernels/ssd_chunk.py:61"),
        # the backwards: the TPU kernels are forward-only and the reference
        # differentiates its plain jnp versions
        summary("rmsnorm_bwd", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:23"),
        summary("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:69"),
        # the SSD scan's backward: the TPU kernel is forward-only too
        summary("ssd_chunk_scan_bwd", "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
                "src/repro/kernels/ssd_chunk.py:61"),
    ]})
    print(f"host cpu: {cpu}", flush=True)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
