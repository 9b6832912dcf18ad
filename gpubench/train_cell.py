"""A training cell: the port's optimizer step on one device.

Set-up builds one training step object -- the model from
``repro_torch.models.build_model``, the step from
``repro_torch.train.train_step.make_train_step`` under AdamW and the traffic's
schedule, fp32 masters and moments made from the seed -- and drives it through
its first ``checked_steps`` steps, fed by the port's ``Prefetcher`` with this
benchmark's token batches.  Those steps warm up every shape of the cell and
are the ones the reference follows.  The window then runs the same object on
from there (``window.run_window``).  With ``trace``, the window is recorded
by ``torch.profiler`` with the device alone (busy and idle over all of it),
``loss_and_grads`` and ``adamw_update`` are timed by CUDA events (they are
wrapped where the step looks them up), and after the window ``traced_steps``
more steps are recorded with host ops too (each op's kernels, the idle gaps
by host op).  Once the program's state is freed, the reference runs the
checked steps again from the seed and ``check`` compares."""

from __future__ import annotations

import contextlib
import gc
import sys
import time
import types

import torch

from gpubench import check, host, weights, window
from gpubench import trace as tracing
from gpubench.feed import MarkovFeed
from gpubench.reference import model as ref_model
from gpubench.reference import train as ref_train


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def optimizer_settings(traffic: dict) -> dict:
    opt = traffic["optimizer"]
    if opt["schedule"] != "cosine":
        raise ValueError(f"the reference follows the cosine schedule, not {opt['schedule']!r}")
    return opt


class Program:
    """The system under test for one cell and seed: the step object, its
    state, and the feed."""

    def __init__(self, cell, seed: int, device: torch.device):
        from repro_torch.configs.base import ArchConfig
        from repro_torch.data.pipeline import Prefetcher
        from repro_torch.models import ModelOptions, build_model
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.optim.schedule import get_schedule
        from repro_torch.train.train_step import make_train_step

        arch, tr = cell.config["arch"], cell.traffic
        opt = optimizer_settings(tr)
        self.device, self.seed, self.arch = device, seed, arch
        cfg, opts = ArchConfig(**arch), ModelOptions(**cell.config["options"])
        self.model = build_model(cfg, opts, device)
        self.spec = ref_model.param_spec(arch)
        t0 = time.perf_counter()
        # the models' layout; a leaf the loss does not reach makes the step raise
        self.params = weights.tree(weights.make(self.spec, seed, device))
        self.opt_state = init_opt_state(self.params)
        _sync(device)
        self.weights_s = time.perf_counter() - t0
        self.b1 = opt["b1"]
        schedule = get_schedule(opt["schedule"], opt["peak_lr"], opt["warmup_steps"], opt["total_steps"])
        self.step_fn = make_train_step(
            self.model, AdamWConfig(lr=schedule, b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                                    weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"]),
            microbatches=tr["microbatches"])
        self.feed = MarkovFeed(arch["vocab"], tr["seq"], tr["batch"], seed, tr["branching"])
        self.prefetch = Prefetcher(self.feed)
        self.losses: list = []
        self.data_wait_s: list = []

    def step(self) -> None:
        t0 = time.perf_counter()
        _, batch = self.prefetch.next()
        self.data_wait_s.append(time.perf_counter() - t0)
        self.params, self.opt_state, metrics = self.step_fn(self.params, self.opt_state, batch)
        self.losses.append(metrics["loss"])

    def first_steps(self, n: int) -> dict:
        """Run the checked steps; returns what ``check.numbers`` compares."""
        grad_norms = None
        for i in range(n):
            self.step()
            if i == 0:
                grad_norms = self._norms(self.opt_state["m"], 1.0 / (1.0 - self.b1))
        losses = [float(x) for x in torch.stack(self.losses[:n]).cpu()]
        with torch.no_grad():
            flat = weights.flatten(self.params)
            change = {}
            for group in weights.groups(self.spec):
                start = weights.make_group(self.spec, self.seed, group, self.device)
                names = list(start)
                norms = torch.stack([torch.linalg.vector_norm(flat[p] - start[p]) for p in names])
                change.update(zip(names, norms.tolist()))
                del start
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

    @torch.no_grad()
    def _norms(self, tree, scale: float) -> dict:
        flat = weights.flatten(tree)
        names = list(flat)
        norms = torch.stack([torch.linalg.vector_norm(flat[p]) for p in names]) * scale
        return dict(zip(names, norms.tolist()))

    def close(self) -> None:
        self.prefetch.close()


class StepClock:
    """CUDA events around ``loss_and_grads`` and ``adamw_update`` where the
    unmeshed step looks them up (``repro_torch.train.train_step``'s globals),
    put back by ``remove``."""

    NAMES = ("loss_and_grads", "adamw_update")

    def __init__(self):
        import repro_torch.train.train_step as ts

        self.module, self.saved, self.pairs = ts, {}, {n: [] for n in self.NAMES}
        for name in self.NAMES:
            fn = getattr(ts, name, None)
            if fn is not None:
                self.saved[name] = fn
                setattr(ts, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.pairs[name].append((start, end))
            return out
        return timed

    def remove(self) -> None:
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def ms(self, name: str) -> list:
        return [s.elapsed_time(e) for s, e in self.pairs[name]]


def reference_steps(cell, seed: int, device: torch.device, precision: str = "fp32",
                    fault: str | None = None) -> dict:
    """The reference's checked steps from the seed (the same weights and
    batches as the program's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch, tr = cell.config["arch"], cell.traffic
    spec = ref_model.param_spec(arch)
    feed = MarkovFeed(arch["vocab"], tr["seq"], tr["batch"], seed, tr["branching"])
    batches = [{k: torch.from_numpy(v).to(device) for k, v in feed.batch(i).items()}
               for i in range(tr["checked_steps"])]
    params = weights.make(spec, seed, device)
    out = ref_train.train(arch, params, batches, optimizer_settings(tr), ref_model.Precision(precision),
                          lambda g: weights.make_group(spec, seed, g, device), fault)
    del params, batches
    free(device)
    return out


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _allocator(device: torch.device) -> dict:
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc", "num_device_free")}


def _device_profile(device: torch.device):
    """A profiler that records the device alone (the tests' CPU: host ops)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU])


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        wrap_step=None) -> types.SimpleNamespace:
    """One run of a training cell; returns the reader's ``run`` namespace
    with ``nums`` (the check's numbers).  ``wrap_step(program)`` may replace
    ``program.step_fn`` before the first step (the tests' planted faults)."""
    if cell.workload["chips"] != 1:
        raise ValueError(f"{cell.name}: a training cell runs on one device, not {cell.workload['chips']}")
    tr = cell.traffic
    t_made = time.perf_counter()
    prog = Program(cell, seed, device)
    if wrap_step is not None:
        wrap_step(prog)
    t0 = time.perf_counter()
    first = prog.first_steps(tr["checked_steps"])
    # set-up's objects are left out of the collector's scans in the window
    gc.collect()
    gc.freeze()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup: {t_made - t_start:.3f} s to the program (imports, CUDA, kernels' build), "
        f"{t0 - t_made:.3f} s to make it (weights {prog.weights_s:.3f} s), "
        f"{time.perf_counter() - t0:.3f} s for {tr['checked_steps']} checked steps; setup_s {setup_s:.3f} s")

    n_before = len(prog.losses)
    clock = StepClock() if trace and device.type == "cuda" else None
    before, alloc = host.sample(), _allocator(device)
    try:
        with _device_profile(device) if trace else contextlib.nullcontext() as prof:
            win = window.run_window(prog.step, seconds, lambda: _sync(device))
    finally:
        if clock is not None:
            clock.remove()
    log(f"window: {win.steps} steps in {win.seconds:.4f} s; host ms a step: "
        + " ".join(f"{1e3 * t:.1f}" for t in win.step_s))
    log(f"host over the window: {host.describe(before, host.sample())}; allocator over the window: "
        + ", ".join(f"{k} +{v - alloc[k]}" for k, v in _allocator(device).items()))
    window_losses = prog.losses[n_before:]
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    data_wait = prog.data_wait_s[n_before:]

    summary = None
    if trace:
        t1 = time.perf_counter()
        summary = tracing.device_summary(tracing.events(prof, host_ops=False)[0], win.seconds)
        del prof
        log(f"trace of the window, device alone: busy {summary.busy_s:.4f} of {win.seconds:.4f} s, "
            f"reduced in {time.perf_counter() - t1:.3f} s")
        host_ops(prog, tr["traced_steps"], summary)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog.close()
    del prog
    gc.unfreeze()
    free(device)

    t0 = time.perf_counter()
    ref = reference_steps(cell, seed, device)
    log(f"reference: {tr['checked_steps']} steps in {time.perf_counter() - t0:.3f} s")
    nums, about = check.compare(first, ref)
    log(f"check: leaves left out of change_gap {len(about['left_out'])} {about['left_out'][:8]}; "
        f"worst leaf {about['worst']}")
    return types.SimpleNamespace(
        arch=cell.config["arch"], traffic=tr, tokens_per_step=tr["batch"] * tr["seq"],
        setup_s=setup_s, window=win, attempted=win.steps, failed=failed, data_wait_s=data_wait,
        fwd_bwd_ms=clock.ms("loss_and_grads") if clock and clock.pairs["loss_and_grads"] else None,
        optimizer_ms=clock.ms("adamw_update") if clock and clock.pairs["adamw_update"] else None,
        trace=summary, peak_bytes=peak, nums=nums, first=first, ref=ref)


def host_ops(prog: Program, n: int, summary) -> None:
    """``n`` more steps recorded with host ops too: each op's device time and
    calls and the idle gaps by host op, into ``summary``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    device = prog.device
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _sync(device)
        with record_function(tracing.WINDOW):
            for _ in range(n):
                with record_function(tracing.STEP):
                    prog.step()
            _sync(device)
    t2 = time.perf_counter()
    ops = tracing.summarize(*tracing.events(prof))
    del prof
    log(f"trace with host ops: {n} steps in {ops.window_s:.4f} s, busy {ops.busy_s:.4f} s, reduced in "
        f"{time.perf_counter() - t2:.3f} s ({t2 - t1:.3f} s traced)")
    summary.op_kernel_s, summary.op_calls, summary.idle_gaps = ops.op_kernel_s, ops.op_calls, ops.idle_gaps
