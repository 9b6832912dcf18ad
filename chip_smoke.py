#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # from the root of the checkout

Phases, each printing one JSON object on a line of its own; any failure
raises and the script exits non-zero:

1. ``env``     -- the card (name, power limit), torch/CUDA versions, TF32 setting.
2. ``build``   -- compiles ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
   (one process per source, all at once).
3. ``kernels`` -- calls each kernel's wrapper at the shapes the serving path
   gives it (plus one ragged fp32 case), holds the result against the plain
   PyTorch version on the same inputs, and times kernel, plain version and the
   one PyTorch library call that computes the same function (a yardstick; the
   port never calls it) with CUDA events after warm-up.
4. ``parity``  -- glm4-9b at full width, 4 layers: one padded prefill and a few
   decode steps, logits through the kernels against logits through the plain
   versions, in fp32 and in bf16.
5. ``serve``   -- glm4-9b at full width and full depth (40 layers, bf16, random
   weights from a seed) serving 16 seeded requests through ``ServeEngine``;
   checks every result, the page allocator and the kernels' launch counts.

With ``--profile`` a sixth phase traces one decode step and one prefill with
``torch.profiler`` (device-busy time against the host's wall clock).

Then the ``kernels`` summary line (launches on the serving path, error, times
and roofline bound per kernel), the card as ``nvidia-smi`` names it, and the
verdict as the last line.  There is no CPU path: without a CUDA device the
script exits non-zero before printing anything.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    EngineConfig,
    LengthMixture,
    LoadGenConfig,
    ServeEngine,
    ServeReport,
    generate_requests,
)

# Published peaks of one H100 SXM (dense, no sparsity); bounds are stated
# against these whatever the card's power limit, which is printed beside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2**20

# |kernel - plain| <= TOL + TOL * |plain| elementwise (the reference's own test
# rule, rtol = atol): bf16 results differ by one rounding of the output, which
# grows with the value (2e-2); fp32 differs by the order of the sums (1e-4).
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


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
    case = {
        "kernel": "rmsnorm", "shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err, "tol": TOL[dtype],
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


def flash_case(b: int, hq: int, hkv: int, sq: int, skv: int, hd: int, dtype: torch.dtype,
               gen: torch.Generator, iters: int, model_layout: bool, offset: int = 0,
               causal: bool = True) -> dict:
    """``model_layout``: tensors held as (b, s, h, hd) and passed as transposed
    views, as the model does.  ``offset``: elements by which each tensor's
    storage is shifted (1 breaks the 16-byte alignment of bf16 rows)."""
    dev = gen.device

    def rand(h: int, s: int) -> torch.Tensor:
        shape = (b, s, h, hd) if model_layout else (b, h, s, hd)
        flat = torch.randn(math.prod(shape) + offset, device=dev, dtype=torch.float32,
                           generator=gen).to(dtype)
        t = flat[offset:].view(shape)
        return t.transpose(1, 2) if model_layout else t   # logical (b, h, s, hd)

    q, k, v = rand(hq, sq), rand(hkv, skv), rand(hkv, skv)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    err = compare(got, want, f"flash_attention q{tuple(q.shape)} kv{tuple(k.shape)} {dtype}")
    args = [(q, k, v)]
    case = {
        "kernel": "flash_attention", "q": list(q.shape), "kv": list(k.shape),
        "layout": "(b,s,h,hd) strided" if model_layout else "(b,h,s,hd) contiguous",
        "rows_16_byte_aligned": q.data_ptr() % 16 == 0, "causal": causal,
        "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err, "tol": TOL[dtype],
    }
    timings(
        case,
        kernel=(lambda *a: ops.flash_attention(*a, causal=causal), args, iters),
        plain=(lambda *a: ref.flash_attention_ref(*a, causal=causal), args, iters),
        # the library's causal mask is aligned top-left: the same function only if sq == skv
        library=(lambda *a: F.scaled_dot_product_attention(*a, is_causal=causal, enable_gqa=True),
                 args, iters) if sq == skv or not causal else None,
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


def kernels_phase(cfg, dev: torch.device) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(1)
    hd = cfg.resolved_head_dim
    bf16, fp32 = torch.bfloat16, torch.float32
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
    ]
    emit({"phase": "kernels", "cases": cases})
    return cases


# ------------------------------------------------------------------- parity
def plain_kernels():
    """Route the model's kernel calls to the plain versions (comparison only)."""
    return mock.patch.multiple(ops, rmsnorm=ref.rmsnorm_ref, flash_attention=ref.flash_attention_ref)


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

    def cast(tree, dtype):
        if isinstance(tree, dict):
            return {k: v if k == "norm_scale" else cast(v, dtype) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, dtype) for v in tree]
        return tree.to(dtype)

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


# -------------------------------------------------------------------- serve
def serve_phase(cfg, dev: torch.device, n_layers: int):
    if n_layers != cfg.n_layers:
        print(f"NOTE: depth cut from {cfg.n_layers} to {n_layers} layers; widths unchanged")
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
    }
    if counts != expected or stats.prefills != len(requests):
        raise AssertionError(f"launch counts {counts}, expected {expected}")

    report = ServeReport.from_run(results, stats)
    emit({
        "phase": "serve", "model": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "dtype": "bfloat16",
        "engine": dataclasses.asdict(engine_cfg), "init_s": init_s, "wall_s_with_warmup": wall_s,
        "prefills": stats.prefills, "decode_steps": stats.decode_steps,
        "launches": counts, "launches_in_warmup": {
            "rmsnorm": norms_per_forward * (1 + n_buckets),
            "flash_attention": cfg.n_layers * n_buckets},
        "report": report.to_dict(),
        "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    return counts, model, params


# ------------------------------------------------------------------ profile
def _profiled(fn, repeats: int) -> dict:
    """Run ``fn`` ``repeats`` times under torch.profiler: wall and device-busy
    milliseconds per repeat, kernels launched per repeat, heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list[float]] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "device_time", None)
            if us is None:
                us = evt.cuda_time
            entry = by_name.setdefault(evt.name, [0.0, 0])
            entry[0] += us / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "wall_ms": wall_ms / repeats, "device_busy_ms": busy_ms / repeats,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops": sum(n for _, n in by_name.values()) / repeats,
        "top_kernels": [{"name": name[:80], "ms": ms / repeats, "calls": n / repeats}
                        for name, (ms, n) in top],
    }


@torch.no_grad()
def profile_phase(model, params, dev: torch.device) -> None:
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

    emit({"phase": "profile", "n_layers": model.cfg.n_layers,
          "decode_step_8_lanes_512_cached": _profiled(decode, 5),
          "prefill_1024": _profiled(prefill, 2)})


# --------------------------------------------------------------------- main
def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--layers", type=int, default=0,
                        help="depth of the serve phase (default: the model's own, 40)")
    parser.add_argument("--profile", action="store_true",
                        help="also trace a decode step and a prefill with torch.profiler")
    parser.add_argument("--ptxas-info", action="store_true",
                        help="print each kernel's registers and shared memory from the build")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    # fp32 products stay full fp32 (the reference's fp32 tests are held to 1e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    emit({"phase": "env", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    _build.build_all(("-Xptxas", "-v") if args.ptxas_info else ())
    emit({"phase": "build", "seconds": _build.build_seconds,
          "sources": [os.path.relpath(s, ROOT) for s in _build.sources()],
          "flags": list(_build.NVCC_FLAGS)})

    cfg = get_config("glm4-9b")
    cases = kernels_phase(cfg, dev)
    parity_phase(cfg, dev)
    counts, model, params = serve_phase(cfg, dev, args.layers or cfg.n_layers)
    if args.profile:
        profile_phase(model, params, dev)

    def summary(name: str, case: dict, source: str, replaces: str) -> dict:
        if counts[name] <= 0:
            raise AssertionError(f"the serving path never launched {name}")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": case["max_abs_err"],
            "ms": case["kernel_ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "shape": case.get("shape") or {"q": case["q"], "kv": case["kv"]},
            "dtype": case["dtype"],
        }

    emit({"kernels": [
        summary("rmsnorm", cases[0], "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:23"),
        summary("flash_attention", cases[4], "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:69"),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
