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
   routes; plus ragged, unaligned and small cases), holds
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
   its nodes taken through every registered policy, and the Arnold rank grid
   of the "hier" placement (every TP group inside one node).  Its times are
   the host CPU's, printed beside the card.
6. ``serve``   -- glm4-9b at full width and full depth (40 layers, bf16, random
   weights from a seed) serving 16 seeded requests through ``ServeEngine``;
   checks every result, the page allocator and the kernels' launch counts.
7. ``zamba_parity`` -- zamba2-2.7b at full width, 12 layers: a 300-token
   forward through the kernels against the plain versions in fp32 and bf16
   (weights and tokens from four seeds), and the fp32 teacher-forced decode
   against the forward (first seed).
8. ``zamba``   -- zamba2-2.7b at full width and full depth (54 layers, bf16,
   random weights from a seed): one 32768-token forward, then 128 decode
   steps at batch 8; checks the outputs and the exact launch counts.
9. ``train_parity`` -- minicpm-2b at full width, 4 layers, fp32 masters: the
   loss and every parameter's gradient on one batch of 4 x 1024 tokens
   through the kernels (forward and backward) against autograd through the
   plain versions, in fp32 and in bf16 compute (rule in the phase).
10. ``train``   -- minicpm-2b at full width and full depth (40 layers) with the
   reference's defaults (bf16 compute, fp32 masters and AdamW state, remat):
   8 steps of ``make_train_step`` on ``SyntheticDataset`` batches under a WSD
   schedule; checks finite, falling loss, every gradient present and finite,
   the exact launches of each step; reports step time, tokens/s, TFLOP/s and
   peak memory.
11. ``trainer`` -- the reduced config on the card through
   ``repro_torch.launch.train.main``, and a ``Trainer`` restarted by a
   ``FaultInjector`` against an uninterrupted one (final checkpoints
   bit-identical); then reduced zamba2-2.7b, qwen3-moe-235b-a22b and
   phi-3-vision-4.2b through the launcher, each once with a step failing and
   restored, once uninterrupted (bit-identical: the MoE's dispatch and
   combine sum in a fixed order).
12. ``zamba_train_parity`` -- ``train_parity`` for zamba2-2.7b at full width,
   12 layers (two units), fp32 masters, fp32 and bf16 compute.
13. ``zamba_train`` -- zamba2-2.7b at full width and depth (54 Mamba2 layers,
   the shared block applied 9 times), bf16 compute on fp32 masters, remat of
   each Mamba2 layer: 8 steps of ``make_train_step`` under its cosine schedule,
   with ``train``'s checks and reports.
14. ``moe_parity`` -- qwen3-moe-235b-a22b (128 experts, top-8) at full width,
   2 layers: ``parity``, the plain run held to the kernel run's routes; fp32
   routes identical, in bf16 the share the plain run would flip reported
   (rule in the phase).
15. ``moe_serve`` -- qwen3-moe at full width and 12 of its 94 layers (62 GB of
   bf16 weights: one card's cut) through ``serve``'s engine, requests and
   checks.
16. ``moe_train_parity`` -- ``train_parity`` for qwen3-moe at 1 layer, the
   plain run held to the kernel run's routes (rule in the phase).
17. ``moe_train`` -- qwen3-moe at full width and 1 layer (59.7 GB of fp32
   weights, gradients and AdamW moments): ``train``'s 8 steps, checks and
   reports, a finite aux loss at every step, model FLOPs over the active
   (top-8) experts.
18. ``vlm_train_parity`` -- ``train_parity`` for phi-3-vision-4.2b at full
   width, 4 layers, with 576 patch embeddings from a seed before the 1024
   tokens (flash attention at head dim 96 over 1600 positions).
19. ``vlm_train`` -- phi-3-vision at full width and depth (32 layers): 8
   steps of ``train`` with its patches.

With ``--profile`` further phases, after ``serve``, ``zamba``,
``train_parity``, ``train``, ``zamba_train``, ``moe_serve``, ``moe_train`` and
``vlm_train``, trace a decode step and a prefill of each served model, one
fp32-compute ``loss_and_grads`` of ``train_parity``'s model (the launcher's
dtype) and one train step of each trained model with ``torch.profiler``
(device-busy time against the host's wall clock, and the flash and SSD
kernels' shares, the SSD backward's kernels apart, the MoE's routing,
dispatch, expert GEMMs and combine apart).

Then the ``kernels`` summary line (the three forwards and the three
backwards: launches over every main path -- serve, zamba, train,
zamba_train, moe_serve, moe_train, vlm_train -- error, times and roofline
bound per kernel), the host's CPU model, the card as ``nvidia-smi`` names it,
and the verdict as the last line.  There is no CPU path: without a CUDA device the
script exits non-zero before printing anything.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Cluster,
    JobSpec,
    ModelSpec,
    ScheduleRequest,
    build_comm_matrix,
    get_scheduler,
    list_schedulers,
    weighted_spread,
)
from repro_torch.data import Prefetcher, SyntheticDataset  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as _fa  # noqa: E402
from repro_torch.kernels import rmsnorm as _rms  # noqa: E402
from repro_torch.kernels import ssd_chunk as _ssd  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import arnold_rank_grid, grid_group_spread  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
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
from repro_torch.train.train_step import batch_to_device  # noqa: E402

# Published peaks of one H100 SXM (dense, no sparsity); bounds are stated
# against these whatever the card's power limit, which is printed beside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def emit(obj: dict) -> None:
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
    lse_err = None
    if with_lse:
        got, lse = _fa.flash_attention_cuda(q, k, v, causal, with_lse=True)
        torch.cuda.synchronize()
        want, want_lse = ref.flash_attention_lse_ref(q, k, v, causal)
        lse_err = compare(lse, want_lse, f"{what} lse")
        del lse, want_lse
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
        "lse_max_abs_err": lse_err,
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
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * dtype.itemsize
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
    out, lse = _fa.flash_attention_cuda(q, k, v, causal, with_lse=True)
    got = _fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    again = _fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
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
        kernel=(lambda *a: _fa.flash_attention_bwd_cuda(*a, causal), args, iters),
        plain=(lambda *a: ref.flash_attention_bwd_ref(*a, causal), args, max(1, iters // 4)),
        library=None,
    )
    # its backward faults on inputs shifted off 16 bytes, so it gets aligned
    # copies of the same values
    case["library_ms"] = timed_grad_ms(library_attention(sq, skv, causal, hq // hkv),
                                       [t.clone() for t in (q, k, v)], dout.clone(), iters)
    visible = sum(min(skv, i + skv - sq + 1) for i in range(sq)) if causal else sq * skv
    # five products of 2 hd flops per visible pair: S (recomputed), dP, dV, dQ, dK
    flops = 10 * b * hq * visible * hd
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + out.numel() + dout.numel()) * dtype.itemsize \
        + lse.numel() * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    case["bound_ms"] = max(by_bytes, by_ops)
    case["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    case["kernel_tflops"] = flops / case["kernel_ms"] / 1e9
    return case


def flash_lse_case(b: int, hq: int, hkv: int, s: int, hd: int, dtype: torch.dtype,
                   gen: torch.Generator) -> dict:
    """The forward's out is bit-identical with and without lse, and lse
    agrees with the plain version's (fp32 rule); model layout, causal."""
    q, k, v = (torch.randn((b, s, h, hd), device=gen.device, generator=gen).to(dtype).transpose(1, 2)
               for h in (hq, hkv, hkv))
    alone = _fa.flash_attention_cuda(q, k, v, True)
    out, lse = _fa.flash_attention_cuda(q, k, v, True, with_lse=True)
    torch.cuda.synchronize()
    if not torch.equal(alone, out):
        raise AssertionError(f"flash forward q{tuple(q.shape)} {dtype}: storing lse changed out")
    _, want = ref.flash_attention_lse_ref(q, k, v, True)
    return {"kernel": "flash_attention", "case": "lse", "q": list(q.shape), "kv": list(k.shape),
            "dtype": str(dtype).removeprefix("torch."), "route": _fa.flash_plan(q, k, v, out).route,
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


def kernels_phase(cfg, zcfg, mcfg, qcfg, vcfg, dev: torch.device) -> dict[str, dict]:
    """Every kernel case; returns the case of each kernel at its main paths'
    heaviest shape (zamba2-2.7b's 32k prefill for the three forwards,
    minicpm-2b's training step for the RMSNorm and flash backwards, zamba2's
    for the SSD backward).  ``qcfg``/``vcfg``: qwen3-moe-235b-a22b's and
    phi-3-vision-4.2b's shapes (flash at hd 96 on both routes)."""
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
    emit({"phase": "kernels", "cases": cases + zamba_cases + train_cases + zamba_train_cases
          + moe_vlm_cases})
    return {"rmsnorm": rmsnorm_main, "flash_attention": flash_main, "ssd_chunk_scan": ssd_main,
            "rmsnorm_bwd": rmsnorm_bwd_main, "flash_attention_bwd": flash_bwd_main,
            "ssd_chunk_scan_bwd": ssd_bwd_main}


# ------------------------------------------------------------------- parity
PLAIN = {"rmsnorm": ref.rmsnorm_ref, "flash_attention": ref.flash_attention_ref,
         "ssd_chunk_scan": ref.ssd_chunk_scan_ref}


def plain_kernels(keep: str | None = None):
    """Route the model's kernel calls, all but ``keep``'s, to the plain
    versions (comparison only)."""
    return mock.patch.multiple(ops, **{name: fn for name, fn in PLAIN.items() if name != keep})


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


def moe_parity_phase(cfg, dev: torch.device, n_layers: int = 2) -> None:
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

    report = {"phase": "moe_parity", "model": cfg.name, "n_layers": n_layers,
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
            raise AssertionError(f"moe_parity: the plain run launched kernels, or the kernel run "
                                 f"did not: {counts} -> {ops.launch_counts()}")
        # every routed (token, layer, k): the bucket's padding and the idle lanes too
        n_routes = sum(i.numel() for i, _ in log)
        flipped = sum(int(f) for f in flips)
        scale = max(b.abs().max().item() for b in through_plain)
        finite = all(torch.isfinite(a).all().item() for a in through_kernels)
        if dtype == torch.float32:
            if flipped:
                raise AssertionError(f"moe_parity float32: {flipped} of {n_routes} routes differ")
            diff = max(compare(a, b, "moe_parity float32 logits")
                       for a, b in zip(through_kernels, through_plain))
            tol = TOL[dtype]
        else:
            diff = max((a - b).abs().max().item() for a, b in zip(through_kernels, through_plain))
            tol = TOL[dtype] * scale
        if not finite or not diff <= tol:
            raise AssertionError(f"moe_parity {name}: max abs logit diff {diff} > {tol} "
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


def placement_phase(card: str, cpu: str) -> None:
    """The scheduling core on the card's host, in ``examples/serve.py``'s
    order (place the replicas, then serve one): (a) two glm4-9b replicas
    (TP 8, PP 2) placed through ``place_replicas`` on a 4 x 4 cluster; (b)
    the "hier" tier at ``bench_latency``'s 10k-node workload -- cold, flat
    MILP, warm re-solve after one node fails, the same request again; (c) a
    9600-GPU job (TP 8, PP 8, 150 DP groups, the paper's scale) on that
    cluster with 30 % of its nodes taken, through every registered policy,
    and the Arnold rank grid of the "hier" placement."""
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
    for name in list_schedulers():
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
    over ZAMBA_SEQ tokens, then decode_step at batch 8 from a fresh cache (64
    teacher-forced prompt tokens, 64 greedy).  Returns the launch counts, the
    model and its parameters."""
    lanes, prompt_len, n_greedy = 8, 64, 64
    model = build_model(cfg, ModelOptions("bfloat16", "bfloat16"), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab, (1, ZAMBA_SEQ), device=dev, generator=gen)
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
        fwd_ok = logits.shape == (1, ZAMBA_SEQ, cfg.padded_vocab) and \
            bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        forward_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del logits

        cache = model.init_cache(lanes, ZAMBA_SEQ)
        kv_len = cache["kv"]["k"].shape[2]
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
        raise AssertionError(f"zamba: forward ok {fwd_ok}, decode logits finite {bool(finite)}, "
                             f"index {cache['index']}/{steps}, tokens {tuple(out.shape)}")
    if fwd_counts != zamba_launches(cfg, 1, 0) or dec_counts != zamba_launches(cfg, 0, steps):
        raise AssertionError(f"zamba launch counts: forward {fwd_counts}, expected "
                             f"{zamba_launches(cfg, 1, 0)}; decode {dec_counts}, expected "
                             f"{zamba_launches(cfg, 0, steps)}")
    emit({
        "phase": "zamba", "model": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "dtype": "bfloat16", "init_s": init_s,
        "forward": {"tokens": ZAMBA_SEQ, "batch": 1,
                    "note": "prefill_32k's sequence, its batch cut from 32 to 1",
                    "wall_s": forward_s, "tokens_per_s": ZAMBA_SEQ / forward_s,
                    "peak_device_memory_gb": forward_peak_gb, "launches": fwd_counts},
        "decode": {"lanes": lanes, "teacher_forced": prompt_len, "greedy": n_greedy,
                   "kv_len": kv_len, "ms_per_step": decode_s * 1e3 / steps,
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


def train_data(cfg, seed: int = 0) -> SyntheticDataset:
    """TRAIN_BATCH x TRAIN_SEQ tokens a batch, and for a VLM its patch
    embeddings from the same seed, as the launcher makes them."""
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = ((TRAIN_BATCH, cfg.n_patches, cfg.d_model), "float32")
    return SyntheticDataset(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=seed, extra_specs=extra)


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
              "tokens": TRAIN_BATCH * TRAIN_SEQ, "rule": {"float32": 1e-4, "bfloat16": 5e-2}}
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
    AdamW state): ``SyntheticDataset(seed 0)`` batches of TRAIN_BATCH x
    TRAIN_SEQ tokens under the config's schedule (peak TRAIN_LR, 2 warm-up
    steps).  Checks finite, falling loss, the first step's cross-entropy
    within 0.5 of ln(vocab) (a MoE's loss adds 0.01 aux to it), a finite aux
    loss at every step, every gradient present and finite, and ``expected``,
    the exact launches of every step."""
    cfg = model.cfg
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
            and losses[-1] < losses[0]):
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
          "tokens": TRAIN_BATCH * TRAIN_SEQ, "train_step": _profiled(step, 1, model.cfg.is_moe)})


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

    cfg, zcfg, mcfg = get_config("glm4-9b"), get_config("zamba2-2.7b"), get_config("minicpm-2b")
    qcfg, vcfg = get_config("qwen3-moe-235b-a22b"), get_config("phi-3-vision-4.2b")
    cases = kernels_phase(cfg, zcfg, mcfg, qcfg, vcfg, dev)
    torch.cuda.empty_cache()   # the 32k plain attention's graph pool
    parity_phase(cfg, dev)
    placement_phase(card, cpu)
    serve_counts, model, params = serve_phase(cfg, dev, args.layers or cfg.n_layers)
    if args.profile:
        profile_phase(model, params, dev)
    del model, params
    torch.cuda.empty_cache()
    zamba_parity_phase(zcfg, dev)
    zamba_counts, model, params = zamba_phase(zcfg, dev)
    if args.profile:
        profile_zamba_phase(model, params, dev)
    del model, params
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
    trainer_phase(mcfg, dev)
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
    train_parity_phase(vcfg, dev, 4, "vlm_train_parity")
    torch.cuda.empty_cache()
    vlm_train_counts, *train_state = train_phase(vcfg, dev, phase="vlm_train")
    if args.profile:
        profile_train_phase(*train_state, phase="profile_vlm_train")
    del train_state
    torch.cuda.empty_cache()
    # every kernel ran on a main path: the three forwards on zamba2's, rmsnorm
    # and flash attention on glm4's and qwen3-moe's serving and on every
    # training, their backwards on every training, the SSD scan's forward and
    # backward on zamba2's training
    trained = (train_counts, moe_train_counts, vlm_train_counts)
    if min(zamba_counts[k] for k in ("rmsnorm", "flash_attention", "ssd_chunk_scan")) <= 0 or \
            min(c[k] for c in (serve_counts, moe_serve_counts)
                for k in ("rmsnorm", "flash_attention")) <= 0 or \
            min(c[k] for c in trained for k in ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                                                "flash_attention_bwd")) <= 0 or \
            min(zamba_train_counts.values()) <= 0:
        raise AssertionError(f"a main path never launched a kernel: serve {serve_counts}, "
                             f"zamba {zamba_counts}, train {train_counts}, "
                             f"zamba_train {zamba_train_counts}, moe_serve {moe_serve_counts}, "
                             f"moe_train {moe_train_counts}, vlm_train {vlm_train_counts}")
    paths = (serve_counts, zamba_counts, train_counts, zamba_train_counts, moe_serve_counts,
             moe_train_counts, vlm_train_counts)

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
