"""Fault-tolerant training loop: checkpoint-restart, auto-resume after
simulated node failures, prefetched data -- the reference's
``train/trainer.py``.

State lives in (checkpoint, step) and data is a pure function of step, so
``Trainer.run`` can be killed at any point and re-invoked to continue
bit-exactly.  Batches are made in numpy by the prefetch thread and moved to
the model's device by the train step.  A meshed ``step_fn``
(``make_train_step(..., mesh=...)``) runs on every rank of the process group
with the same data; the state is made in its layout (``step_fn.
state_shardings``) and the checkpoint restores it laid out.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import Prefetcher, SyntheticDataset
from repro_torch.models.transformer import init_laid_out
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    keep_ckpts: int = 3
    microbatches: int = 1
    async_ckpt: bool = False
    seed: int = 0


class StepFailure(RuntimeError):
    """A training step died for an operational reason (node crash, injected
    fault, device loss) -- the checkpoint-restart path in :meth:`Trainer.run`
    handles exactly this type.  Genuine programming errors stay ordinary
    exceptions and propagate."""


class FaultInjector:
    """Deterministic failure schedule for tests/examples: raises at given
    steps, once each (models a node crash surfacing as a step exception)."""

    def __init__(self, fail_at: list[int]):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise StepFailure(f"injected node failure at step {step}")


class Trainer:
    """Parameters start from ``model.init`` on a generator of the model's
    device seeded with ``cfg.seed`` (the reference draws from ``PRNGKey(seed)``:
    the same distribution, other bits)."""

    def __init__(
        self,
        model,
        dataset: SyntheticDataset,
        opt_cfg: AdamWConfig,
        ckpt_dir,
        cfg: TrainerConfig = TrainerConfig(),
        fault_injector: Optional[FaultInjector] = None,
        on_step: Optional[Callable] = None,
    ):
        self.model = model
        self.dataset = dataset
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.ckpt = Checkpointer(ckpt_dir, keep_last=cfg.keep_ckpts, use_async=cfg.async_ckpt)
        self.fault = fault_injector
        self.on_step = on_step
        self.step_fn = make_train_step(model, opt_cfg, microbatches=cfg.microbatches)
        self.history: list[dict] = []

    # ------------------------------------------------------------------ state
    def _generator(self) -> torch.Generator | None:
        """The seeded generator ``model.init`` draws from (none on ``meta``)."""
        if self.model.device.type == "meta":
            return None
        return torch.Generator(device=self.model.device).manual_seed(self.cfg.seed)

    def _init_state(self):
        """Fresh parameters and moments.  Under a meshed ``step_fn`` the state
        is made in its layout (``step_fn.state_shardings``): each parameter
        drawn whole and cut to this rank's shard before the next is drawn
        (``init_laid_out``: gathered, ``model.init``'s tree bit for bit), the
        moments made as shards; a rank never holds the whole tree."""
        layouts = getattr(self.step_fn, "state_shardings", None)
        if layouts is None:
            params = self.model.init(self._generator())
            return params, init_opt_state(params)
        params = init_laid_out(self.model, self._generator(), lambda t: layouts(t)["params"])
        return params, init_opt_state(params, layouts(params)["opt"]["m"])

    def _restore_or_init(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return *self._init_state(), 0
        # The template: the state's tree, shapes, dtypes and devices with no
        # storage (the reference's jax.eval_shape).  Under fake tensors
        # model.init allocates nothing and draws nothing from its generator.
        with FakeTensorMode():
            params = self.model.init(self._generator())
            opt_state = init_opt_state(params)
        template = {"params": params, "opt": opt_state}
        layouts = getattr(self.step_fn, "state_shardings", None)
        if layouts is None:
            state = self.ckpt.restore(template, step=latest)
        else:   # a meshed step: the state comes back laid out as the step holds it
            state = self.ckpt.restore(template, step=latest, shardings=layouts(params))
        return state["params"], state["opt"], latest

    # -------------------------------------------------------------------- run
    def run(self, max_retries: int = 3) -> list[dict]:
        """Train to total_steps, restarting from the last checkpoint on a
        :class:`StepFailure` (up to ``max_retries`` *consecutive* times: the
        counter resets whenever a checkpoint lands past the last restart
        point, so a long run survives arbitrarily many spaced-out failures
        while a step that can never progress still fails fast).  Any other
        exception is a programming error and propagates."""
        retries = 0
        last_restart: Optional[int] = None
        while True:
            try:
                self._run_once()
                self.ckpt.wait()
                return self.history
            except StepFailure as e:
                latest = self.ckpt.latest_step() or 0
                if last_restart is not None and latest > last_restart:
                    retries = 0  # made checkpointed progress since last restart
                retries += 1
                if retries > max_retries:
                    raise
                last_restart = latest
                # fault-tolerance path: restore from the last checkpoint
                self.history.append({"event": "restart", "error": str(e)})

    def _run_once(self):
        params, opt_state, start = self._restore_or_init()
        prefetch = Prefetcher(self.dataset, start_step=start)
        try:
            step = start
            while step < self.cfg.total_steps:
                data_step, batch = prefetch.next()
                if data_step != step:
                    raise RuntimeError(f"prefetcher handed step {data_step}, trainer at {step}")
                if self.fault is not None:
                    self.fault.maybe_fail(step)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                step += 1
                if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                    loss = float(metrics["loss"])   # waits for the device
                    self.history.append(
                        {
                            "step": step,
                            "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "step_time": time.perf_counter() - t0,
                        }
                    )
                    if self.on_step:
                        self.on_step(self.history[-1])
                if step % self.cfg.ckpt_every == 0 or step == self.cfg.total_steps:
                    self.ckpt.save(step, {"params": params, "opt": opt_state})
        finally:
            prefetch.close()

    def losses(self) -> list[float]:
        return [h["loss"] for h in self.history if "loss" in h]
