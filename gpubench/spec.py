"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration (the entry's ``file``), its traffic mix
(``traffic/<name>.json``), the code that runs it (``<kind>_cell.py``, the
mix's ``kind``: ``train_cell.py`` for ``"train"``), its correctness limits
(``limits/<cell>.json``) and one reader a metric (``metrics/<metric>.py``, a
``read(run)`` that returns a number or None).  A later cell, mix or metric is a new file and a
new entry; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    root: Path                 # the checkout that holds BENCHMARK.json
    workload: dict             # the cell's entry in "workloads"
    config: dict               # the configuration file's contents
    traffic: dict              # the traffic mix's parameters
    limits: dict               # {number: limit} of the correctness check
    end_to_end: list           # the end-to-end metrics this cell reports
    per_layer: list            # the per-layer metrics this cell reports

    @property
    def name(self) -> str:
        return self.workload["name"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files, which lie
    under ``root/gpubench`` (or the directory named by the configuration's
    ``file``).  Raises KeyError naming the cells there are."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; there are {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[work["config"]]["file"]).read_text())
    base = root / "gpubench"
    traffic = json.loads((base / "traffic" / f"{work['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{name}.json").read_text())
    return Cell(root, work, config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def _load(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path):
    """``read(run)`` of ``root/gpubench/metrics/<metric>.py``."""
    return _load(root / "gpubench" / "metrics" / f"{metric}.py", f"gpubench_metric_{metric}").read


def runner(cell: Cell):
    """``run(cell, seed, seconds, trace, device, t_start, wrap_step)`` of
    ``gpubench/<kind>_cell.py`` under the cell's checkout, ``kind`` its
    traffic mix's."""
    kind = cell.traffic["kind"]
    return _load(cell.root / "gpubench" / f"{kind}_cell.py", f"gpubench_cell_{kind}").run


def read_metrics(metrics: list, run, root: Path) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader returns a number."""
    out = {}
    for m in metrics:
        value = reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
