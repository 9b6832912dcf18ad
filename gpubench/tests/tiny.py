"""Tiny cells for the CPU tests: two configurations (dense, hybrid), a traffic
mix and limits, added to a copy of the checkout as a later change would add
them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_ARCH = {
    "dense": {"name": "tiny-dense", "family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
              "n_kv_heads": 2, "d_ff": 128, "vocab": 500, "head_dim": 16, "rope_theta": 10000.0,
              "norm_eps": 1e-5, "tie_embeddings": False, "lr_schedule": "cosine"},
    "hybrid": {"name": "tiny-hybrid", "family": "hybrid", "n_layers": 4, "d_model": 64, "n_heads": 4,
               "n_kv_heads": 4, "d_ff": 128, "vocab": 512, "ssm_state": 16, "ssm_heads": 4,
               "ssm_expand": 2, "attn_every": 2, "head_dim": 16, "rope_theta": 10000.0,
               "norm_eps": 1e-5, "tie_embeddings": False, "lr_schedule": "cosine"},
}
TINY_TRAFFIC = {"kind": "train", "batch": 4, "seq": 64, "microbatches": 1, "branching": 4,
                "checked_steps": 3, "traced_steps": 2,
                "optimizer": {"schedule": "cosine", "peak_lr": 1e-3, "warmup_steps": 2,
                              "total_steps": 1000, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                              "weight_decay": 0.1, "grad_clip": 1.0}}
# the tiny cells' limits: between the bf16 program's readings on the CPU and
# the fp8 control's (test_planted_faults.py prints both)
TINY_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.1, "change_gap": 0.2}


def tiny_config(family: str, compute: str = "bfloat16") -> dict:
    return {"source": "tiny", "reduced": [], "arch": copy.deepcopy(TINY_ARCH[family]),
            "options": {"param_dtype": "float32", "compute_dtype": compute, "remat": True}}


def make_root(tmp: Path) -> Path:
    """A checkout in ``tmp``: the repository's benchmark files and two tiny
    cells (``tiny-dense.train.4x64``, ``tiny-hybrid.train.4x64``) added as
    files and entries, as a later change would add them."""
    shutil.copytree(REPO / "gpubench", tmp / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for family in TINY_ARCH:
        name = TINY_ARCH[family]["name"]
        (tmp / "gpubench" / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(family)))
        bench["configs"].append({"name": name, "source": "tiny", "file": f"gpubench/configs/{name}.json",
                                 "reduced": [], "why": "a CPU test"})
        cell = f"{name}.train.4x64"
        bench["workloads"].append({"name": cell, "config": name, "traffic": "train.4x64", "chips": 1,
                                   "why": "a CPU test"})
        (tmp / "gpubench" / "limits" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS))
    (tmp / "gpubench" / "traffic" / "train.4x64.json").write_text(json.dumps(TINY_TRAFFIC))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
