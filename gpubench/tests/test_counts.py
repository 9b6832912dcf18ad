"""The roofline and model-FLOP counts against figures worked by hand, and the
trace reduction on a hand-made trace."""

from __future__ import annotations

import dataclasses
import json

import pytest

from gpubench.tests.tiny import REPO
from gpubench import counts, trace


def arch(name):
    path = REPO / "gpubench" / "configs" / f"{name}.json"
    if path.is_file():
        return json.loads(path.read_text())["arch"]
    from repro_torch.configs import get_config   # a configuration of the port's with no cell

    return dataclasses.asdict(get_config(name))


def test_phi4_mini_model_flops():
    a = arch("phi4-mini-3.8b")
    layer = 3072 * 3072 * 2 + 3072 * 1024 * 2 + 3 * 3072 * 8192   # q, o; k, v; SwiGLU
    n = 32 * layer + 3072 * 200064                                  # + the head, not the embedding
    assert counts.matmul_params(a) == n == 3_835_822_080
    attn = 4 * 4 * 24 * (1024 * 1025 // 2) * 128                   # one layer's causal forward
    assert counts.model_flops(a, 4, 1024) == 6 * n * 4096 + 3 * 32 * attn


def test_zamba2_counts_the_shared_block_at_each_use():
    a = arch("zamba2-2.7b")
    mamba = 2560 * (2 * 5120 + 2 * 64 + 80) + 5120 * 2560
    shared = 4 * 2560 * 2560 + 3 * 2560 * 10240
    assert counts.matmul_params(a) == 54 * mamba + 9 * shared + 2560 * 32000
    attn = 4 * 4 * 32 * (1024 * 1025 // 2) * 80
    assert counts.model_flops(a, 4, 1024) == 6 * counts.matmul_params(a) * 4096 + 3 * 9 * attn


def test_flash_bounds_by_hand():
    a = arch("phi4-mini-3.8b")
    ops = 4 * 4 * 24 * (1024 * 1025 // 2) * 128
    nbytes = 2 * 4 * 1024 * 128 * (2 * 24 + 2 * 8) + 4 * 4 * 24 * 1024
    assert counts.flash_fwd_bound_s(a, 4, 1024) == pytest.approx(max(ops / 989e12, nbytes / 3.35e12))
    assert ops / 989e12 > nbytes / 3.35e12                         # bound by operations
    bwd_bytes = 2 * 4 * 1024 * 128 * (4 * 24 + 4 * 8) + 4 * 4 * 24 * 1024
    assert counts.flash_bwd_bound_s(a, 4, 1024) == pytest.approx(
        max(2.5 * ops / 989e12, bwd_bytes / 3.35e12))


def test_the_idle_share_covers_the_gaps_between_steps():
    ms = 1_000_000
    host = [trace.HostOp(trace.WINDOW, 1, 0, 100 * ms),
            trace.HostOp("step", 1, 0, 40 * ms), trace.HostOp("step", 1, 50 * ms, 90 * ms),
            trace.HostOp("_FlashAttention", 1, 10 * ms, 12 * ms),
            trace.HostOp("cudaLaunchKernel", 1, 11 * ms, 11 * ms + 10, correlation=7),
            trace.HostOp("cudaLaunchKernel", 1, 20 * ms, 20 * ms + 10, correlation=8)]
    dev = [trace.Activity("flash_fwd_kernel", 12 * ms, 30 * ms, 7),
           trace.Activity("nvjet_gemm", 25 * ms, 45 * ms, 8),
           trace.Activity("nvjet_gemm", 60 * ms, 80 * ms, 9),
           trace.Activity(trace.WINDOW, 0, 100 * ms, -1)]   # the range's annotation: not work
    s = trace.summarize(dev, host)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.053)                 # 12-45 and 60-80 ms
    assert s.idle_share == pytest.approx(0.47)              # the 45-60 ms gap between steps counts
    assert s.op_kernel_s == {"_FlashAttention": pytest.approx(0.018), "step": pytest.approx(0.038)}
    assert s.op_calls["_FlashAttention"] == 1 and s.op_calls["step"] == 2
    assert s.kernel_s["nvjet_gemm"] == pytest.approx(0.04)
    gaps = dict(s.idle_gaps)
    # a gap goes to the innermost op open at its start: 0-12 and 80-100 ms to a
    # step, 45-60 ms (between the steps) to none
    assert gaps["step"] == pytest.approx(0.012 + 0.02)
    assert gaps[trace.NO_OP] == pytest.approx(0.015)
    assert s.device_ops[0] == ["nvjet_gemm", pytest.approx(0.04)]
