"""The port's dry run (``repro_torch.launch.dryrun``) and hill-climbing driver
(``repro_torch.launch.perf``) against the reference's ``launch/dryrun.py``.

* The convention: FLOPs are global, summed over chips -- one rank's local
  ops times the chips.  On a (2, 2) fake world, reduced minicpm-2b's meshed
  train step (4 x 64 tokens, remat, bf16 compute) counts exactly what
  ``FlopCounterMode`` counts for the unmeshed step: 444 596 224.
* The bilinear (layers x microbatches) fit equals the count traced at full
  depth where both run.
* Collectives against the reference's analysis compile of the same cell
  (``_lower_cell`` on an ``AxisType.Auto`` (2, 2) mesh, in a subprocess, as
  ``tests/jax_parallel_oracle.py`` runs the reference).  XLA's CPU backend
  moves bf16 collectives in f32 (its convert fusions), so elements are
  compared, not bytes; it all-reduces the ZeRO-3 gradients where DTensor
  reduce-scatters them, so a reduce-scatter counts as all-reduce of the whole
  tensor it reduces; both gather each layer's weights inside the layer's
  checkpoint, but the analysis compile unrolls the layers and, its
  checkpoints made with ``prevent_cse=False``, merges the recompute's gathers
  with the forward's, so the port's second gather of each layer's weights
  (the recompute's) is not counted; the reference replays the forward's
  all-reduces in its recompute, where the port stops its recompute at the
  last tensor the backward needs, and it reshards activations with
  all-to-alls and permutes that DTensor does not issue.  So the port's kinds,
  so mapped, are a subset of the reference's, its all-gathered elements
  within 20 % of the reference's (0.998 measured; the port gathers the tied
  table at the lookup and at the logits) and all its elements within 30 %
  (0.838).
* The counterpart of ``tests/test_roofline.py::TestDryrunCell``: the CLI on
  whisper-tiny x decode_32k x single in a subprocess (256 fake ranks).
* ``perf.py`` refuses the variants whose options the port leaves out.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, perf
from repro_torch.models import ModelOptions, build_model, input_specs
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = ShapeSpec("probe", 64, 4, "train")   # 4 x 64 tokens


def env() -> dict:
    return {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


def traced(cfg, opts, microbatches: int = 1):
    """One meshed train step of ``cfg`` on a (2, 2) fake world."""
    from torch.distributed.device_mesh import init_device_mesh

    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        return dryrun._trace(cfg, CELL, mesh, opts, microbatches)


@pytest.fixture(scope="module")
def minicpm():
    cfg = get_config("minicpm-2b").reduced()
    opts = dryrun.options_for("minicpm-2b", "train_4k")
    return cfg, opts, traced(cfg, opts)


def test_meshed_flops_are_global_and_equal_the_unmeshed_count(minicpm):
    cfg, opts, trace = minicpm
    model = build_model(cfg, opts, "meta")
    params = model.init()
    counter = FlopCounterMode(display=False)
    with counter:
        make_train_step(model, AdamWConfig(lr=3e-4))(params, init_opt_state(params),
                                                     input_specs(cfg, CELL, opts))
    assert counter.get_total_flops() == 444_596_224
    assert trace.counts.flops * 4 == counter.get_total_flops()


def test_memory_of_the_traced_step(minicpm):
    """The arguments are local shards: bf16 parameters and fp32 moments (10
    bytes a parameter) over the 4 ranks, the replicated norm scales a little
    more, and the batch; the step's peak lies above them."""
    from torch.utils._pytree import tree_leaves

    cfg, opts, trace = minicpm
    n = sum(t.numel() for t in tree_leaves(build_model(cfg, opts, "meta").init()))
    assert 10 * n / 4 <= trace.argument_bytes < 10 * n / 2
    assert trace.peak_bytes > trace.argument_bytes


def test_the_memory_account_by_hand():
    """``StepCounts``'s account on a (2, 2) fake world: a storage counts from
    the op that creates it until its last tensor dies; a view and an in-place
    result add nothing; a DTensor counts by its local shard; an argument,
    passed twice, is held and never counted."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.empty(32, 16, device="meta"), mesh, [Shard(0), Shard(1)])
        counts = dryrun.StepCounts()
        counts.hold((x, x))
        with counts:
            a = torch.empty(1000, device="meta")   # 4000 bytes
            y = x * 2                                # a (32, 16) fp32 shard: 2048
            v = y.t()                                # a view: 0
            y.add_(1)                                # in place: 0
            z = a + x.to_local().sum()               # 4000 (the scalar sum: 4)
            live = counts.live_bytes
            del a, z
            w = v * 1                                # 2048
        assert (x * 1).shape == (64, 32)             # outside the account
    assert live == 4000 + 2048 + 4000
    assert counts.peak_bytes == 4000 + 2048 + 4 + 4000   # the sum's scalar, until z is made
    assert counts.live_bytes == 2048 + 2048          # y (through v) and w
    del y, v, w
    assert counts.live_bytes == 0


def test_the_peak_of_a_decode_cell_by_hand():
    """A meshed decode step of reduced glm4-9b (4 layers, 4 query heads on 2 kv
    heads of 16) on a (2, 2) fake world, 8 lanes over an 8192-slot bf16 cache:
    each rank holds 4 lanes and 1 kv head.  Above its arguments, the step's
    peak is one layer's attention over its cache shard (``attention_decode``):
    K and V repeated to the rank's 2 query heads in bf16, K upcast to fp32 and
    made contiguous for the product, the fp32 scores.  Rule: the count equals
    that reckoning within 2 % (the token's projections, norms and mask ride on
    top)."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_config("glm4-9b").reduced()
    opts = dryrun.options_for("glm4-9b", "decode_32k")
    lanes, slots, heads, hd = 8 // 2, 8192, cfg.n_heads // 2, cfg.resolved_head_dim
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        trace = dryrun._trace(cfg, ShapeSpec("probe", slots, 8, "decode"), mesh, opts, 1)
    repeated = lanes * slots * heads * hd * 2                  # bf16, K and V
    upcast = lanes * slots * heads * hd * 4                    # fp32 K, and its contiguous copy
    scores = lanes * heads * slots * 4
    reckoning = 2 * repeated + 2 * upcast + scores
    temp = trace.peak_bytes - trace.argument_bytes
    assert abs(temp - reckoning) <= 0.02 * reckoning, (temp, reckoning)


def test_a_real_step_counts_what_its_trace_counts():
    """The account of a real step on the CPU (reduced minicpm-2b's meshed
    train step in a fake world of one, 2 x 256 tokens) equals the account of
    its trace on meta, peak and arguments, to the byte."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_config("minicpm-2b").reduced()
    cell = ShapeSpec("probe", 256, 2, "train")
    opts = dryrun.options_for("minicpm-2b", "train_4k")
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        trace = dryrun._trace(cfg, cell, mesh, opts, 1)
        args, step, arg_bytes = dryrun._cell_step(cfg, cell, mesh, opts, 1, device="cpu")
        counts = dryrun.StepCounts()
        counts.hold(args)
        with counts:
            step(*args)
    assert arg_bytes == trace.argument_bytes
    assert counts.peak_bytes == trace.peak_bytes - trace.argument_bytes > 0


def test_bilinear_fit_equals_the_full_depth_trace():
    """Traced at 2 and 4 layers, 1 and 2 microbatches, fitted to 6 layers and
    4 microbatches: FLOPs and collective bytes equal the trace at (6, 4); 16
    sequences, so that every microbatch's batch still divides over ``data``
    (a microbatch that does not is replicated, and its cost is no longer
    linear in the microbatches).  The per-op bytes are exactly linear in the
    layers; not in the microbatches from one (one microbatch skips the
    gradient accumulation's passes), so they are checked at one."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_config("minicpm-2b").reduced()
    opts = dryrun.options_for("minicpm-2b", "train_4k")
    cell = ShapeSpec("probe", 32, 16, "train")
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        grid = {}
        for L in (2, 4):
            for M in (1, 2):
                c = dryrun._trace(dataclasses.replace(cfg, n_layers=L), cell, mesh, opts,
                                  M).counts
                grid[(L, M)] = (float(c.flops), float(c.op_bytes), dict(c.bytes))
        direct = dryrun._trace(dataclasses.replace(cfg, n_layers=6), cell, mesh, opts, 4).counts
        one = dryrun._trace(dataclasses.replace(cfg, n_layers=6), cell, mesh, opts, 1).counts
    flops, _, coll = dryrun.fit_counts(grid, 6, 4)
    assert flops == pytest.approx(direct.flops, rel=1e-12)
    _, op_bytes, _ = dryrun.fit_counts({k: v for k, v in grid.items() if k[1] == 1}, 6, 1)
    assert op_bytes == pytest.approx(one.op_bytes, rel=1e-12)
    assert coll.keys() == direct.bytes.keys()
    for kind, b in direct.bytes.items():
        assert coll[kind] == pytest.approx(b, rel=1e-12), kind
    assert dryrun.grid_points(get_config("qwen3-moe-235b-a22b"), 16) == ((12, 24), (1, 2))
    assert dryrun.grid_points(get_config("zamba2-2.7b"), 1) == ((12, 24), (1,))   # whole units
    assert dryrun.grid_points(get_config("minicpm-2b"), 2) == ((40,), (2,))


#: the four-card cells (``chip_smoke.py --cards 4``): 8 x 1024 tokens, the
#: launcher's recipe -- fp32 masters, bf16 compute, remat
CARDS = ShapeSpec("cards", 1024, 8, "train")


def cards_trace(arch: str, layers: int, world: int = 4):
    """One meshed train step of ``arch`` at full width and ``layers`` deep in
    the four-card cell, on a (2, 2) fake world (a (1, 1) world of one)."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    opts = ModelOptions(param_dtype="float32", compute_dtype="bfloat16", remat=True)
    shape = (2, 2) if world == 4 else (1, 1)
    with dryrun.fake_world(world):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        return dryrun._trace(cfg, CARDS, mesh, opts, 1)


def test_a_rank_holds_one_layer_of_gathered_weights():
    """ZeRO-3 gathered at use, one layer at a time: from 4 to 5 layers of
    dbrx-132b at full width the peak a rank grows by one layer's quarter of
    fp32 parameters, moments and gradients (16 bytes a parameter over 4
    ranks: 13.04 GB), within 1 %; with the whole tree gathered before the
    first layer it grew by 16.35 GB.  The recompute gathers each layer again:
    a layer adds two gathers of its TP-half of fp32 weights (13.04 GB) to the
    all-gathers, and its MoE's expert buffers gathered back over ``model``
    (forward, recompute, backward: 0.76 GB at 8 x 1024 tokens), less than
    10 % more."""
    from torch.utils._pytree import tree_leaves

    four, five = cards_trace("dbrx-132b", 4), cards_trace("dbrx-132b", 5)
    layer = build_model(dataclasses.replace(get_config("dbrx-132b"), n_layers=1),
                        ModelOptions(param_dtype="float32"), "meta").init()["layers"][0]
    n = sum(t.numel() for t in tree_leaves(layer))
    share = 16 * n / 4
    assert share == pytest.approx(13.04e9, rel=1e-3)
    assert abs((five.peak_bytes - four.peak_bytes) - share) <= 0.01 * share
    gathered = five.counts.bytes["all-gather"] - four.counts.bytes["all-gather"]
    assert 2 * 4 * n / 2 <= gathered <= 1.1 * 2 * 4 * n / 2


def test_the_glm4_four_card_cell_fits_in_45_gb():
    """``chip_smoke.py --cards 4``'s glm4-9b cell (``mesh_cards_glm4``), 40
    layers: 53.69 GB a rank with the whole tree gathered, 44.43 GB gathered
    layer by layer."""
    trace = cards_trace("glm4-9b", 40)
    assert trace.peak_bytes <= 45e9
    assert trace.argument_bytes == 28_200_992_768


@pytest.mark.parametrize("arch", ("glm4-9b", "dbrx-132b"))
def test_a_world_of_one_and_the_unmeshed_step_are_unchanged(arch):
    """Where nothing is sharded over ``data`` nothing is gathered: the peak of
    a world of one and of the unmeshed step (2 layers at full width, the
    four-card cell's recipe) are the counts of the tree that gathered the
    whole parameter tree before the step, to the byte."""
    one = cards_trace(arch, 2, world=1)
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    opts = ModelOptions(param_dtype="float32", compute_dtype="bfloat16", remat=True)
    model = build_model(cfg, opts, "meta")
    params = model.init()
    args = (params, init_opt_state(params), input_specs(cfg, CARDS, opts))
    counts = dryrun.StepCounts()
    counts.hold(args)
    with counts:
        make_train_step(model, AdamWConfig(lr=3e-4))(*args)
    want = {"glm4-9b": (39_926_259_716, 16_408_289_300),
            "dbrx-132b": (140_932_317_208, 43_688_779_800)}[arch]
    assert (one.peak_bytes, counts.peak_bytes) == want


def reference_collectives() -> dict:
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                                   "--xla_backend_optimization_level=0")
        import json, sys
        import jax
        jax.devices()   # four host devices, before the reference's module sets 512
        from jax.sharding import AxisType
        from repro.configs import get_config
        from repro.configs.base import ShapeSpec
        from repro.launch import dryrun
        from repro.launch.roofline import parse_collective_bytes

        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:4])
        opts = dryrun.options_for("minicpm-2b", "train_4k",
                                  {"scan_layers": False, "attn_impl": "xla"})
        lowered = dryrun._lower_cell(get_config("minicpm-2b").reduced(),
                                     ShapeSpec("probe", 64, 4, "train"), mesh, opts, 1,
                                     unroll_microbatches=True)
        print(json.dumps(parse_collective_bytes(lowered.compile().as_text())))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def recompute_gathered_elements(cfg, opts) -> int:
    """The elements a rank gathers again in the remat recompute of a meshed
    step on the (2, 2) mesh: each layer leaf sharded over ``data``, gathered
    whole over ``data`` (its ``model`` shard)."""
    from repro_torch.parallel.sharding import map_with_path, param_spec

    sizes, out = {"data": 2, "model": 2}, []

    def leaf(path, t):
        spec = param_spec(path, t.shape, sizes)
        names = [n for e in spec if e for n in (e if isinstance(e, tuple) else (e,))]
        if path.startswith("layers/") and "data" in names:
            out.append(t.numel() // (2 if "model" in names else 1))

    map_with_path(leaf, build_model(cfg, opts, "meta").init())
    return sum(out)


def test_collectives_against_the_reference_analysis_compile(minicpm):
    ref = {k: v / 4 for k, v in reference_collectives().items()}   # f32 on XLA's CPU backend
    cfg, opts, trace = minicpm
    port = dict(trace.counts.elements)
    port["all-reduce"] = port.get("all-reduce", 0) + 2 * port.pop("reduce-scatter", 0)
    port["all-gather"] -= recompute_gathered_elements(cfg, opts)
    assert set(port) <= set(ref)
    assert 0.8 <= port["all-gather"] / ref["all-gather"] <= 1.2
    assert 0.7 <= sum(port.values()) / sum(ref.values()) <= 1.3


def test_whisper_decode_cell_on_256_fake_ranks(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
         "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / "dryrun.jsonl").read_text().splitlines()[0])
    assert rec["status"] == "ok"
    assert rec["chips"] == 256
    assert rec["roofline"]["collective_bytes"] > 0
    assert rec["memory"]["peak_bytes_per_device"] < 80 * 2**30
    assert {"trace_s", "memory", "roofline", "microbatches", "overrides"} <= rec.keys()


def test_left_out_options_are_refused():
    with pytest.raises(ValueError, match="attn_impl"):
        dryrun.options_for("minicpm-2b", "train_4k", {"attn_impl": "chunked"})
    assert set(perf.REFUSED) == {"attn_chunk_512", "attn_chunk_2048", "attn_chunk_4096",
                                 "attn_xla"}
    for name in perf.REFUSED:
        with pytest.raises(ValueError, match=name):
            perf.run_variant("minicpm-2b", "train_4k", name)


def test_perf_refuses_attn_xla_by_name(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf", "--arch", "whisper-tiny",
         "--shape", "decode_32k", "--variant", "baseline", "--variant", "attn_xla",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env(), cwd=ROOT)
    assert proc.returncode == 2
    assert "'attn_xla'" in proc.stderr and "attn_impl" in proc.stderr
    assert not list(tmp_path.iterdir())   # nothing ran, the baseline neither
