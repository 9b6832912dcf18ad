"""The harness finds every part of a cell by name, and a new configuration,
traffic mix and per-layer metric are taken as new files and entries, with no
edit to a file that is there."""

from __future__ import annotations

import json

import pytest
import torch

from gpubench.tests.tiny import REPO
from gpubench import spec

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = spec.load_cell(cell, REPO)
    assert c.config["arch"] and c.traffic["kind"] == "train"
    assert c.limits and set(c.limits) <= {"loss_gap", "grad_gap", "change_gap"}
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"], REPO))


def test_an_unknown_cell_names_the_cells_there_are():
    with pytest.raises(KeyError, match="phi4-mini.train.4x1024"):
        spec.load_cell("no.such.cell", REPO)


def test_the_contract_shape_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    layers = {m["name"]: m for m in BENCH["end_to_end"]}
    assert layers["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in layers and set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("gpubench/")


def test_new_files_make_a_new_cell_and_metric(tiny_root, capsys):
    """A later change adds a configuration, a traffic mix, its limits, a
    metric reader and their entries; the harness runs the new cell and reads
    the new metric, and no file that was there changes."""
    from gpubench import run

    before = {p: p.read_bytes() for p in (tiny_root / "gpubench").rglob("*") if p.is_file()}
    reader = tiny_root / "gpubench" / "metrics" / "steps_run.probe.py"
    reader.write_text("def read(run):\n    return run.window.steps\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_run.probe", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "trainer", "moves": "tokens_per_s",
                               "workloads": ["tiny-hybrid.train.4x64"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (0, 1):
        rc = run.main(["--workload", "tiny-hybrid.train.4x64", "--seed", "4294967311", "--seconds",
                       "0.3", "--trace", str(trace)], device=torch.device("cpu"), root=tiny_root)
        assert rc == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"]
        if trace:
            assert line["metrics"]["steps_run.probe"]["value"] == line["attempted"]
        else:
            assert set(line["metrics"]) == {"tokens_per_s", "setup_s"}   # no card: no peak
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_new_kind_of_cell_is_a_new_file(tiny_root, capsys):
    """A traffic mix's ``kind`` names the code that runs its cells:
    ``gpubench/<kind>_cell.py``, found by name like every other part."""
    from gpubench import run

    (tiny_root / "gpubench" / "probe_cell.py").write_text(
        "from gpubench import train_cell\n\n\n"
        "def run(cell, *args, **kwargs):\n"
        "    out = train_cell.run(cell, *args, **kwargs)\n"
        "    out.probe = 7.0\n"
        "    return out\n")
    (tiny_root / "gpubench" / "metrics" / "probe.py").write_text("def read(run):\n    return run.probe\n")
    traffic = json.loads((tiny_root / "gpubench" / "traffic" / "train.4x64.json").read_text())
    (tiny_root / "gpubench" / "traffic" / "probe.4x64.json").write_text(json.dumps({**traffic, "kind": "probe"}))
    (tiny_root / "gpubench" / "limits" / "tiny-dense.probe.4x64.json").write_text(
        (tiny_root / "gpubench" / "limits" / "tiny-dense.train.4x64.json").read_text())
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-dense.probe.4x64", "config": "tiny-dense", "traffic": "probe.4x64",
                               "chips": 1, "why": "a CPU test"})
    bench["per_layer"].append({"name": "probe", "unit": "1", "better": "higher", "source": "program_counter",
                               "layer": "trainer", "moves": "tokens_per_s",
                               "workloads": ["tiny-dense.probe.4x64"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc = run.main(["--workload", "tiny-dense.probe.4x64", "--seed", "3", "--seconds", "0.2", "--trace", "1"],
                  device=torch.device("cpu"), root=tiny_root)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["probe"]["value"] == 7.0
