"""Multi-pod dry run, the counterpart of the reference's
``launch/dryrun.py``: trace one step of every (architecture x input shape x
mesh) cell on the production meshes -- single-pod (16, 16) = (data, model)
and multi-pod (2, 16, 16) = (pod, data, model) -- and record memory, FLOPs,
bytes and collective bytes for the roofline (``launch/roofline.py``).

Usage:
    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out reports/

A cell runs in this one process as rank 0 of a ``fake`` world of 256 ranks
(512 for the multi-pod mesh; ``torch.distributed``'s fake backend moves no
bytes) on ``meta`` tensors: parameters from ``init`` of a model built on meta
(drawn from nothing), inputs from ``models.input_specs``, laid out as
the meshed train step (``make_train_step``), forward (prefill) or serve step
(``make_serve_step``) holds them, and one step of it.  Nothing is allocated
and nothing is computed; a cell takes the host time of DTensor's sharding
propagation, reported as ``trace_s``.

What it counts, on rank 0's local ops (a DTensor op is let through first, and
the ops it turns into on the local shards are counted), times the chips --
the reference's per-device ``cost_analysis`` times the chips:

* FLOPs: ``torch.utils.flop_counter``'s formulas (the products).  On meta
  ``kernels.ops`` takes the plain versions (the tensors are not CUDA), so
  attention counts the plain version's full s x s products, as the
  reference's ``attn_impl="xla"`` analysis compile does; no kernel's count is
  held to them.  The recurrences (the xLSTM's steps, the SSD scan's chunks)
  run step by step on meta and are counted by the same formulas, so the
  reference's closed-form ``inner_scan_flops`` correction for what its
  ``while`` bodies hide is recorded (``scan_flops_closed_form``) but not added
  (``scan_flop_correction`` 0).
* bytes: every op's inputs and outputs, one op at a time (an unfused upper
  bound, the role XLA's CPU "bytes accessed" plays in the reference); the
  memory term is ``analytic_hbm_bytes`` with ``attn_impl="flash"``.
* collective bytes by kind: ``roofline.CollectiveBytes``.

Memory per device: ``argument_bytes_per_device`` is the local shards of the
parameters, optimizer state, batch and cache; ``temp_bytes_per_device`` is the
most that the storages the step creates hold at once (``StepCounts``'s own
account: a storage's bytes from the op that creates it until its last tensor
dies, a view or an in-place result never, a DTensor by its local shard); their
sum is ``peak_bytes_per_device``.  The trace takes the plain attention, so the
figure holds its s x s scores, which the flash kernel never allocates.  No
step gathers the whole parameter tree: each layer gathers its ZeRO-3 weights
at its use (``parallel.sharding.gather_at_use``, inside its checkpoint, so the
recompute gathers them again), and the peak holds one layer's gathered
weights at a time.

As in the reference, the analysis counts run at one microbatch (the true
count with ``analysis_true_microbatches``) and, above 48 layers or 2
microbatches, at small (layers, microbatches) points fitted bilinearly; the
production trace (the cell's microbatches, full depth) gives the memory.  The
reference's ``attn_impl`` / ``attn_chunk`` / ``scan_layers`` options have no
counterpart: the flash kernel computes what they select, and the port's
layers are a Python loop.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import pathlib
import sys
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (
    CollectiveBytes,
    Roofline,
    analytic_hbm_bytes,
    inner_scan_flops,
    model_flops_for,
    tensor_bytes,
)
from repro_torch.models import ModelOptions, build_model, input_specs
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.parallel import sharding as shd
from repro_torch.train.train_step import (
    batch_sharding,
    make_serve_step,
    make_train_step,
    shard_batch,
)

META = torch.device("meta")
#: options of the reference's ModelOptions that the port leaves out
LEFT_OUT_OPTIONS = ("attn_impl", "attn_chunk", "scan_layers")


def options_for(arch: str, shape_name: str, overrides: dict | None = None) -> ModelOptions:
    """The baseline options (bf16 weights and compute, remat), with
    ``overrides``; an option the port leaves out raises."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat=True)
    left_out = sorted(set(overrides or {}) & set(LEFT_OUT_OPTIONS))
    if left_out:
        raise ValueError(f"options {left_out} are left out of the port: the flash-attention "
                         "kernel computes what they select")
    kw.update(overrides or {})
    return ModelOptions(**kw)


def microbatches_for(arch: str, shape_name: str, mesh) -> int:
    if SHAPES[shape_name].kind != "train":
        return 1
    sizes = shd.mesh_shape(mesh)
    data = 1
    for a in ("pod", "data"):
        if a in sizes:
            data *= sizes[a]
    per_device = SHAPES[shape_name].global_batch // data
    cfg = get_config(arch)
    if cfg.is_moe:
        return max(1, per_device)    # MoE: 1 seq/device/microbatch (dispatch
                                     # + expert activations are the fat part)
    return max(1, per_device // 2)   # dense: 2 sequences per microbatch


def should_skip(arch: str, shape_name: str) -> str | None:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("skipped: pure full-attention arch at 512k decode "
                "(KV cache exceeds HBM; see DESIGN.md §4)")
    return None


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a ``fake`` world of ``size`` ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process of its own: a process group is running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


#: allocations: no bytes are read or written
_ALLOCATIONS = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                          "new_empty_strided"})


class StepCounts(CollectiveBytes):
    """``CollectiveBytes`` plus the FLOPs (``flop_counter``'s formulas), the
    bytes every op that is not a view or an allocation reads and writes, and
    the step's memory: ``live_bytes`` is what the storages that the step's ops
    created hold now, ``peak_bytes`` the most they held at once.  A storage
    counts from the op whose output first holds it until its last tensor dies
    (``weakref.finalize`` on the untyped storage); an output that shares a
    storage already counted, an input's or an argument's (:meth:`hold`) -- a
    view, an in-place or ``out=`` result -- adds nothing.  A DTensor op is
    counted as the ops on its local shards, so a DTensor counts by its shard."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.op_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held: dict[int, int] = {}   # id of a counted or held storage -> its bytes

    def hold(self, tree) -> None:
        """Mark the storages of ``tree``'s tensors (the step's arguments, their
        local shards) as held before the step: never counted by it."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._see((t.to_local() if shd.is_dtensor(t) else t).untyped_storage(),
                          count=False)

    def _see(self, storage, count: bool) -> None:
        key = id(storage)
        if key in self._held:
            return
        nbytes = storage.nbytes() if count else 0
        self._held[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._held.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or not self.counted:
            return out
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **(kwargs or {}), out_val=out)
        if not func.is_view and func._overloadpacket.__name__ not in _ALLOCATIONS:
            self.op_bytes += tensor_bytes((args, kwargs)) + tensor_bytes(out)
        if not func.is_view:
            self.hold((args, kwargs))   # an input made before the step is not the step's
            for t in tree_leaves(out):
                # a factory op under DTensor's shape propagation makes a fake tensor
                if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                    self._see(t.untyped_storage(), count=True)
        return out


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors (a plain tensor whole)."""
    return tensor_bytes([t.to_local() if shd.is_dtensor(t) else t
                         for t in tree_leaves(tree) if isinstance(t, torch.Tensor)])


def _cell_step(cfg, shape, mesh, opts: ModelOptions, microbatches: int, rules=None,
               device=META):
    """(args, step): the cell's inputs laid out as its meshed step holds them,
    and ``step(*args)`` running one step; also the local bytes of the
    arguments.  On a ``device`` other than meta the step is real: parameters
    drawn from seed 0, inputs zeros of the specs' shapes (a train or prefill
    cell)."""
    model = build_model(cfg, opts, device)
    specs = input_specs(cfg, shape, opts)
    if model.device == META:
        params = model.init()
    else:
        params = model.init(torch.Generator(device=model.device).manual_seed(0))
        specs = {k: torch.zeros(v.shape, dtype=v.dtype, device=model.device)
                 for k, v in specs.items()}
    if shape.kind == "train":
        step = make_train_step(model, AdamWConfig(lr=3e-4), mesh, microbatches, rules)
        lay = step.state_shardings(params)
        params = shd.lay_out_tree(params, lay["params"])
        opt = init_opt_state(params)
        opt = {"m": shd.lay_out_tree(opt["m"], lay["opt"]["m"]),
               "v": shd.lay_out_tree(opt["v"], lay["opt"]["v"]), "step": 0}
        held = {k: shd.lay_out(v, batch_sharding(v, mesh, rules)) for k, v in specs.items()}
        return (params, opt, specs), step, local_bytes((params, opt, held))

    params = shd.lay_out_tree(params, shd.param_shardings(params, mesh, rules))
    if shape.kind == "prefill":
        def prefill(params, batch):
            with shd.activate(mesh, rules), torch.no_grad():
                logits, _ = model.forward(params, shard_batch(batch, mesh, rules))
            return logits

        held = shard_batch(specs, mesh, rules)
        return (params, specs), prefill, local_bytes((params, held))

    serve = make_serve_step(model, mesh, rules)
    params, cache = serve.lay_out(params, specs["cache"])

    def decode(params, cache, tokens):
        with torch.no_grad():
            return serve(params, cache, tokens)

    return (params, cache, specs["tokens"]), decode, local_bytes((params, cache, specs["tokens"]))


@dataclasses.dataclass
class Trace:
    counts: StepCounts
    argument_bytes: int
    output_bytes: int
    peak_bytes: int   # the arguments plus the step's own peak
    seconds: float


def _trace(cfg, shape, mesh, opts, microbatches, rules=None) -> Trace:
    """One step of the cell, counted."""
    args, step, arg_bytes = _cell_step(cfg, shape, mesh, opts, microbatches, rules)
    counts = StepCounts()
    counts.hold(args)
    t0 = time.perf_counter()
    with counts:
        out = step(*args)
    return Trace(counts, arg_bytes, local_bytes(out), arg_bytes + counts.peak_bytes,
                 time.perf_counter() - t0)


def grid_points(cfg, microbatches: int) -> tuple[tuple, tuple]:
    """The (layers, microbatches) points the analysis traces: the cell's own,
    or above 48 layers / 2 microbatches two small depths (whole units of the
    hybrid's and the xLSTM's repeat) and 1, 2 microbatches, as the reference."""
    if cfg.n_layers > 48:
        step = max(cfg.attn_every or 1, cfg.slstm_every or 1, 1)
        l1 = max(step, (12 // step) * step or step)
        Ls = (l1, 2 * l1)
    else:
        Ls = (cfg.n_layers,)
    Ms = (1, 2) if microbatches > 2 else (microbatches,)
    return Ls, Ms


def fit_counts(grid: dict, L_full: int, M_full: int) -> tuple[float, float, dict]:
    """(flops, bytes, {kind: collective bytes}) at (L_full, M_full) from
    ``grid`` {(layers, microbatches): (flops, bytes, collectives)}: trace cost
    is exactly linear in the layers (identical layers) and in the microbatches
    (identical microbatches), so it is fitted bilinearly, cost = a + b*L + c*M
    + d*L*M -- the reference's fit, in its order of operations."""
    Ls = sorted({L for L, _ in grid})
    Ms = sorted({M for _, M in grid})

    def fit(idx):
        def val(L, M):
            g = grid[(L, M)]
            return g[idx] if idx < 2 else g[2]

        def lin(p1, p2, x1, x2, x):
            return p1 + (p2 - p1) / (x2 - x1) * (x - x1) if x2 != x1 else p1

        if idx < 2:
            # numbers: fit M at each L, then L
            at_L = {
                L: lin(val(L, Ms[0]), val(L, Ms[-1]), Ms[0], Ms[-1], M_full)
                for L in Ls
            }
            return lin(at_L[Ls[0]], at_L[Ls[-1]], Ls[0], Ls[-1], L_full)
        # collectives: per-kind dict
        kinds = {k for g in grid.values() for k in g[2]}
        out = {}
        for k in kinds:
            at_L = {
                L: lin(grid[(L, Ms[0])][2].get(k, 0),
                       grid[(L, Ms[-1])][2].get(k, 0), Ms[0], Ms[-1], M_full)
                for L in Ls
            }
            out[k] = max(0.0, lin(at_L[Ls[0]], at_L[Ls[-1]], Ls[0], Ls[-1], L_full))
        return out

    return fit(0), fit(1), fit(2)


def analyse(cfg, shape, mesh, opts, microbatches: int, rules=None, known: dict | None = None
            ) -> tuple[tuple[float, float, dict], bool]:
    """The step's (flops, bytes, {kind: collective bytes}) per device at
    ``cfg``'s depth and ``microbatches``, traced at :func:`grid_points` and
    fitted (:func:`fit_counts`); ``known`` {(layers, microbatches):
    StepCounts} are points already traced.  Also whether it was fitted."""
    known = known or {}
    Ls, Ms = grid_points(cfg, microbatches)
    grid = {}
    for L in Ls:
        for M in Ms:
            c = known.get((L, M))
            if c is None:
                acfg = cfg if L == cfg.n_layers else dataclasses.replace(cfg, n_layers=L)
                c = _trace(acfg, shape, mesh, opts, M, rules).counts
            grid[(L, M)] = (float(c.flops), float(c.op_bytes), dict(c.bytes))
    return fit_counts(grid, cfg.n_layers, microbatches), (Ls, Ms) != ((cfg.n_layers,),
                                                                     (microbatches,))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_overrides: dict | None = None, verbose: bool = True,
             with_analysis: bool | None = None,
             rule_overrides: dict | None = None,
             microbatches: int | None = None,
             analysis_true_microbatches: bool = False) -> dict:
    """Trace one cell in a fake world of the mesh's size (see the module's
    docstring): the production step for memory, then the analysis counts."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    skip = should_skip(arch, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": skip}
    if with_analysis is None:
        with_analysis = not multi_pod  # roofline table is single-pod only
    opts = options_for(arch, shape_name, opt_overrides)

    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        chips = mesh.size()
        mb = microbatches if microbatches is not None else microbatches_for(
            arch, shape_name, mesh)
        rules = None
        if rule_overrides:
            rules = shd.default_rules(mesh.mesh_dim_names)
            rules.update(rule_overrides)

        prod = _trace(cfg, shape, mesh, opts, mb, rules)
        record = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
            "chips": chips, "microbatches": mb,
            "overrides": {"opts": opt_overrides or {}, "rules":
                          {k: list(v) if isinstance(v, tuple) else v
                           for k, v in (rule_overrides or {}).items()}},
            "trace_s": round(prod.seconds, 1),
            "memory": {
                "argument_bytes_per_device": prod.argument_bytes,
                "output_bytes_per_device": prod.output_bytes,
                "temp_bytes_per_device": prod.peak_bytes - prod.argument_bytes,
                "peak_bytes_per_device": prod.peak_bytes,
            },
        }

        if with_analysis:
            # perf runs count the true microbatch count so grad-accumulation
            # effects (weight regathers per microbatch) appear in the totals
            a_mb = mb if analysis_true_microbatches else 1

            known = {(cfg.n_layers, mb): prod.counts}   # the production trace is that point
            (a_flops, a_bytes, collectives), extrapolated = analyse(
                cfg, shape, mesh, opts, a_mb, rules, known)
            closed_form = inner_scan_flops(cfg, shape)
            if shape.kind == "train":
                closed_form *= 3.0  # fwd + bwd (~2x fwd)
            cache_bytes = 0.0
            if shape.kind == "decode":
                cache_bytes = float(tensor_bytes(input_specs(cfg, shape, opts)["cache"]))
            analytic = analytic_hbm_bytes(
                cfg, shape, microbatches=mb, attn_impl="flash",
                remat=opts.remat, kv_cache_bytes=cache_bytes,
            )
            rl = Roofline(
                arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
                hlo_flops=a_flops * chips,
                hlo_bytes=a_bytes * chips,
                collective_bytes=float(sum(collectives.values())) * chips,
                collectives={k: v * chips for k, v in collectives.items()},
                model_flops=model_flops_for(cfg, shape),
                analytic_bytes=analytic,
            )
            record["roofline"] = rl.to_dict()
            record["scan_flop_correction"] = 0.0
            record["scan_flops_closed_form"] = closed_form
            record["analysis_depth_extrapolated"] = extrapolated

    if verbose:
        peak = record["memory"]["peak_bytes_per_device"] or 0
        extra = ""
        if with_analysis:
            rd = record["roofline"]
            extra = (f"  flops={rd['hlo_flops']:.3e}  coll={rd['collective_bytes']:.3e}B"
                     f"  dominant={rd['dominant']}")
        print(
            f"[{arch} x {shape_name} x {mesh_name}] OK  "
            f"trace={record['trace_s']:.0f}s  peak={peak/2**30:.2f} GiB/dev" + extra,
            flush=True,
        )
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--out", default="reports", help="output dir for JSONL")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)
    # DTensor warns of each two-step reduction over (data, model) it plans
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = []
    if args.all:
        for arch in sorted(ARCHS):
            for shape in ["train_4k", "prefill_32k", "decode_32k", "long_500k"]:
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file = out_dir / "dryrun.jsonl"
    mode = "a" if args.append else "w"
    failures = 0
    with open(out_file, mode) as fh:
        for arch, shape in cells:
            for multi in meshes:
                try:
                    rec = run_cell(arch, shape, multi)
                except Exception as e:  # noqa: BLE001 - report and continue
                    failures += 1
                    rec = {
                        "arch": arch, "shape": shape,
                        "mesh": "multi" if multi else "single",
                        "status": f"FAILED: {type(e).__name__}: {e}",
                    }
                    print(f"[{arch} x {shape} x {rec['mesh']}] FAILED: {e}",
                          flush=True)
                    traceback.print_exc()
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
    print(f"wrote {out_file}; failures={failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
