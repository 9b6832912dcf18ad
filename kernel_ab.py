#!/usr/bin/env python3
"""Times the port's RMSNorm and flash-attention kernels (forward and
backward) and its SSD chunk-scan kernel of several checkouts one after the
other on one NVIDIA GPU, so that two versions are compared on the same card,
in the same run.

    python3 kernel_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout of this repo; its ``src/repro_torch``
is imported in a process of its own and its kernels build into that
checkout's ``build/``.  Prints the card as ``nvidia-smi`` names it, then one
JSON line per checkout: device milliseconds per call at each shape (CUDA
events around a CUDA-graph replay of ``ITERS`` calls, after warm-up; bf16,
inputs from a seed; RMSNorm with an fp32 scale, as the models pass it;
causal flash attention's forward with q, k, v contiguous ``(b, h, s, hd)``
at glm4-9b's and minicpm-2b's shapes and in zamba2's model layout ``(b, s, h,
hd)`` at its 4096- and 32768-token shapes (``FLASH_LONG_ITERS`` calls); the causal
flash backward in model layout (q, k, v and dout as transposed views of ``(b,
s, h, hd)`` tensors, out and lse from the forward kernel) at minicpm-2b's
training step, glm4-9b's GQA 16:1 shape and zamba2-2.7b's step, and the
forward with lse that feeds it, as the training forward calls it
(``FLASH_BWD_ITERS`` calls); the
CUDA-core route of both (``FLASH_CORE``: fp32, the forward with lse as the
training forward calls it, and bf16 rows shifted one element off 16 bytes, as
``chip_smoke.py`` runs them); the SSD
scan in zamba2's model layout -- x ``(b, s, H, P)`` bf16 as a transposed
view, B/C ``(b, s, N)`` shared by the heads, dt/loga fp32, y fp32 -- over
``SSD_ITERS`` calls); the SSD scan's backward at zamba2-2.7b's training step
in model layout (bf16 x, fp32 dy, B/C ``(b, s, N)`` shared, dS_final dropped)
and per head at ``b = 2`` (``(b, H, s, .)`` contiguous, with a dS_final)
(``SSD_BWD``); the RMSNorm backward at minicpm-2b's training step in
bf16 (the register route) and fp32 (the block route) (``RMSNORM_BWD``); and
one fp32-compute ``loss_and_grads`` of minicpm-2b at 4 layers under
``torch.profiler`` (device-busy ms and the flash kernels' share).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ITERS = 200
SSD_ITERS = 20
FLASH_LONG_ITERS = 5
RMSNORM = [(8, 1, 2560), (8, 1, 4096), (1, 1024, 4096), (1, 32768, 2560)]
FLASH = [  # (b, hq, hkv, s, hd): glm4-9b's smallest and largest prefill, zamba2's 300 tokens,
    (1, 32, 2, 128, 128), (1, 32, 2, 1024, 128), (2, 8, 8, 300, 80),
    (4, 36, 36, 1024, 64),   # minicpm-2b's training step
]
FLASH_ZAMBA = [(1, 32, 4096, 80), (1, 32, 32768, 80)]   # (b, h, s, hd) in model layout
# (b, hq, hkv, s, hd), model layout: minicpm-2b's step, glm4-9b's GQA 16:1, zamba2-2.7b's step
FLASH_BWD = [(4, 36, 36, 1024, 64), (1, 32, 2, 1024, 128), (4, 32, 32, 1024, 80)]
FLASH_BWD_ITERS = 50
FLASH_CORE = [  # (b, hq, hkv, s, hd, dtype, element offset, model layout, backward too)
    (4, 36, 36, 1024, 64, "float32", 0, True, True),     # minicpm-2b's step in the launcher's fp32
    (4, 36, 36, 1024, 64, "bfloat16", 1, True, True),    # the same, bf16 off by one element
    (1, 4, 4, 150, 80, "float32", 0, False, False),
    (1, 4, 2, 130, 80, "bfloat16", 1, False, False),
]
FLASH_CORE_ITERS = 10
SSD = [(1, 80, 32768, 64, 64), (2, 80, 1024, 64, 64)]   # (b, H, s, P, N): zamba2's 32k forward, b = 2
SSD_BWD = [(4, 80, 1024, 64, 64, True), (2, 80, 1024, 64, 64, False)]   # (b, H, s, P, N, B/C shared)
SSD_BWD_ITERS = 20
RMSNORM_BWD = [((4, 1024, 2304), "bfloat16"), ((4, 1024, 2304), "float32")]   # minicpm-2b's step


def child(root: str) -> dict:
    import torch

    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd_chunk as ssd

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def device_ms(fn, *args, iters: int = ITERS) -> float:
        for _ in range(3):
            fn(*args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn(*args)
        graph.replay()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    out = {"checkout": root, "ms": {}}
    for shape in RMSNORM:
        x, scale = rand(*shape), 1.0 + 0.1 * rand(shape[-1], dtype=torch.float32)
        out["ms"][f"rmsnorm {shape}"] = device_ms(ops.rmsnorm, x, scale, 1e-5)
    for b, hq, hkv, s, hd in FLASH:
        q, k, v = rand(b, hq, s, hd), rand(b, hkv, s, hd), rand(b, hkv, s, hd)
        out["ms"][f"flash q{(b, hq, s, hd)} kv{(b, hkv, s, hd)}"] = device_ms(
            ops.flash_attention, q, k, v, True)
    for b, h, s, hd in FLASH_ZAMBA:
        q, k, v = (rand(b, s, h, hd).transpose(1, 2) for _ in range(3))
        out["ms"][f"flash (b,s,h,hd) {(b, s, h, hd)}"] = device_ms(
            ops.flash_attention, q, k, v, True, iters=FLASH_LONG_ITERS)
    for b, hq, hkv, s, hd in FLASH_BWD:
        q, dout = (rand(b, s, hq, hd).transpose(1, 2) for _ in range(2))
        k, v = (rand(b, s, hkv, hd).transpose(1, 2) for _ in range(2))
        # a bf16 forward with lse also returns its out's residual where the checkout has one
        o, lse, *res = fa.flash_attention_cuda(q, k, v, True, with_lse=True)
        out["ms"][f"flash_bwd (b,s,h,hd) q{(b, s, hq, hd)} kv{(b, s, hkv, hd)}"] = device_ms(
            fa.flash_attention_bwd_cuda, q, k, v, o, lse, dout, True, *res, iters=FLASH_BWD_ITERS)
        out["ms"][f"flash_lse (b,s,h,hd) q{(b, s, hq, hd)} kv{(b, s, hkv, hd)}"] = device_ms(
            fa.flash_attention_cuda, q, k, v, True, True, iters=FLASH_BWD_ITERS)
    for b, hq, hkv, s, hd, dtype, offset, model, bwd in FLASH_CORE:
        def shifted(h):
            shape = (b, s, h, hd) if model else (b, h, s, hd)
            n = shape[0] * shape[1] * shape[2] * shape[3]
            t = torch.randn(n + offset, device=dev, generator=gen).to(getattr(torch, dtype))
            t = t[offset:].view(shape)
            return t.transpose(1, 2) if model else t

        q, dout, k, v = shifted(hq), shifted(hq), shifted(hkv), shifted(hkv)
        name = f"q{(b, hq, s, hd)} kv{(b, hkv, s, hd)} {dtype} offset {offset}"
        out["ms"][f"flash_core lse {name}"] = device_ms(
            fa.flash_attention_cuda, q, k, v, True, True, iters=FLASH_CORE_ITERS)
        if bwd:
            o, lse, *res = fa.flash_attention_cuda(q, k, v, True, with_lse=True)
            out["ms"][f"flash_core_bwd {name}"] = device_ms(
                fa.flash_attention_bwd_cuda, q, k, v, o, lse, dout, True, *res,
                iters=FLASH_CORE_ITERS)
    for b, H, s, P, N in SSD:
        x = rand(b, s, H, P).transpose(1, 2)
        B, C = ((rand(b, s, N) * 0.5)[:, None].expand(b, H, s, N) for _ in range(2))
        dt = torch.nn.functional.softplus(rand(b, s, H, dtype=torch.float32)).transpose(1, 2)
        loga = -torch.nn.functional.softplus(rand(b, s, H, dtype=torch.float32)).transpose(1, 2)
        out["ms"][f"ssd x{(b, H, s, P)} N {N}"] = device_ms(
            ops.ssd_chunk_scan, x, B, C, dt, loga, 128, torch.float32, iters=SSD_ITERS)
    f32 = torch.float32
    for b, H, s, P, N, shared in SSD_BWD:
        if shared:   # the model's layout: x, dy (b, s, H, P), dt/loga (b, s, H)
            x, dy = rand(b, s, H, P).transpose(1, 2), rand(b, s, H, P, dtype=f32).transpose(1, 2)
            B, C = (rand(b, s, N) * 0.5 for _ in range(2))
            dt, loga = (rand(b, s, H, dtype=f32).transpose(1, 2) for _ in range(2))
            dS = None
        else:
            x, dy = rand(b, H, s, P), rand(b, H, s, P, dtype=f32)
            B, C = (rand(b, H, s, N) * 0.5 for _ in range(2))
            dt, loga = rand(b, H, s, dtype=f32), rand(b, H, s, dtype=f32)
            dS = rand(b, H, P, N, dtype=f32)
        dt, loga = torch.nn.functional.softplus(dt), -torch.nn.functional.softplus(loga)
        name = f"ssd_bwd x{(b, H, s, P)} N {N} {'B/C shared' if shared else 'per head'}"
        out["ms"][name] = device_ms(ssd.ssd_chunk_scan_bwd_cuda, x, B, C, dt, loga, dy, dS, 128,
                                    iters=SSD_BWD_ITERS)
    for shape, dtype in RMSNORM_BWD:
        x, dy = (rand(*shape, dtype=getattr(torch, dtype)) for _ in range(2))
        scale = 1.0 + 0.1 * rand(shape[-1], dtype=torch.float32)
        out["ms"][f"rmsnorm_bwd {shape} {dtype}"] = device_ms(rms.rmsnorm_bwd_cuda, x, scale, dy, 1e-5)
    out["fp32_step"] = fp32_step_profile(dev)
    return out


def fp32_step_profile(dev) -> dict:
    """One fp32-compute ``loss_and_grads`` of minicpm-2b at full width, 4
    layers, 4 x 1024 tokens (``chip_smoke.py``'s ``train_parity`` model, the
    launcher's dtype) under ``torch.profiler``, after one untraced call:
    device-busy milliseconds and the flash kernels' share of them."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.train import loss_and_grads
    from repro_torch.train.train_step import batch_to_device

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=4)
    batch = batch_to_device(SyntheticDataset(cfg.vocab, 1024, 4, seed=0).batch(0), dev)
    model = build_model(cfg, ModelOptions("float32", "float32", remat=False), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(4))
    loss_and_grads(model, params, batch)[0].item()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss_and_grads(model, params, batch)[0].item()
        torch.cuda.synchronize()
    busy = flash = 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "device_time", None)
            ms = (evt.cuda_time if us is None else us) / 1e3
            busy += ms
            flash += ms if "flash_" in evt.name else 0.0
    return {"device_busy_ms": busy, "flash_kernels_ms": flash, "flash_share": flash / busy}


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(os.path.abspath(sys.argv[2]))), flush=True)
        return
    roots = sys.argv[1:]
    if not roots:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    for root in roots:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise SystemExit(f"{root}: exit {run.returncode}\n{run.stderr[-4000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
