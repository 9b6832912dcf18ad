"""The reference's first steps: loss and gradients by autograd through
``model.loss`` in fp32, global-norm clipping, and AdamW with decoupled weight
decay on every leaf, under a linear warm-up then cosine schedule:

    g <- g * min(1, clip / ||g||);  m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
    p <- p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

It reads back what the check compares: each step's loss, each leaf's norm of
the first (clipped) gradient, and each leaf's norm of the change of the
parameters over the steps.  ``fault`` plants a fault of the kind the check
must catch, for the readings that set its limits: ``half_batch`` (the loss
and gradients of the first half of the rows alone), ``leaf_unmoved`` (one
leaf is never updated) and ``gradient_zero`` (the gradient of the first
layer's smallest leaf, a norm's scale or a Mamba2 head's ``A_log``, reads
zero, as a backward that drops it would give).  A state left unchanged needs
no run: it reads 1 on the change of every leaf."""

from __future__ import annotations

import math

import torch

from gpubench.reference import model

FAULTS = (None, "half_batch", "leaf_unmoved", "gradient_zero")


def _moments(leaves: list, device) -> list:
    """Zero first moments: on the device, but for the largest leaves in host
    memory where fp32 parameters, gradients, both moments and an update's
    temporaries would not fit (a 4.4 G model on an 80 GB card)."""
    zeros = [None] * len(leaves)
    if device.type == "cuda":
        need = 4 * sum(x.numel() * 4 for x in leaves) + 3 * max(x.numel() * 4 for x in leaves) + 8e9
        room = 0.95 * torch.cuda.mem_get_info(device)[0]
        for i in sorted(range(len(leaves)), key=lambda i: -leaves[i].numel()):
            if need <= room:
                break
            zeros[i] = torch.zeros(leaves[i].shape, dtype=torch.float32, device="cpu")
            need -= leaves[i].numel() * 4
    return [z if z is not None else torch.zeros_like(x) for z, x in zip(zeros, leaves)]


def lr_at(opt: dict, step: int) -> float:
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.1 * peak + 0.9 * peak * 0.5 * (1 + math.cos(math.pi * prog))


def unmoved_leaf(params: dict) -> str:
    """The leaf ``leaf_unmoved`` leaves alone: the first layer's largest."""
    return max((p for p in params if p.startswith("layers.0.")), key=lambda p: params[p].numel())


def zeroed_leaf(params: dict) -> str:
    """The leaf ``gradient_zero`` takes the gradient of: the first layer's
    smallest (the first such in path order)."""
    return min(sorted(p for p in params if p.startswith("layers.0.")), key=lambda p: params[p].numel())


def train(arch: dict, params: dict, batches: list, opt: dict, prec: model.Precision,
          initial, fault: str | None = None) -> dict:
    """``len(batches)`` steps from ``params`` ({path: fp32 leaf}, updated in
    place).  ``initial(group) -> {path: leaf}`` draws a group's starting
    values again, for the change.  Returns {"losses", "grad_norms",
    "change_norms"} as floats ({path: norm} for the last two) and "sizes"
    ({path: number of elements})."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}")
    paths = sorted(params)
    leaves = [params[p].requires_grad_(True) for p in paths]
    m = _moments(leaves, leaves[0].device)
    v = [torch.zeros_like(x) for x in leaves]
    b1, b2, eps, wd, clip = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"], opt["grad_clip"]
    frozen = {unmoved_leaf(params)} if fault == "leaf_unmoved" else set()
    zeroed = zeroed_leaf(params) if fault == "gradient_zero" else None
    losses, grad_norms = [], {}
    for t, batch in enumerate(batches, start=1):
        if fault == "half_batch":
            batch = {k: x[: x.shape[0] // 2] for k, x in batch.items()}
        loss = model.loss(params, batch, arch, prec)
        grads = torch.autograd.grad(loss, leaves)
        if zeroed is not None:
            grads[paths.index(zeroed)].zero_()
        losses.append(loss.item())
        with torch.no_grad():
            norm = torch.stack([torch.linalg.vector_norm(g).double() for g in grads]).square().sum().sqrt()
            scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0).float() if clip else 1.0
            lr, bc1, bc2 = lr_at(opt, t), 1 - b1 ** t, 1 - b2 ** t
            for path, p, g, mi, vi in zip(paths, leaves, grads, m, v):
                g.mul_(scale)
                if t == 1:
                    grad_norms[path] = torch.linalg.vector_norm(g).item()
                mg = mi.to(g.device).mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                if mg is not mi:
                    mi.copy_(mg)
                if path in frozen:
                    continue
                step = (mg / bc1).div_((vi / bc2).sqrt_().add_(eps)).add_(p, alpha=wd)
                p.sub_(step, alpha=lr)
                del mg, step
        del grads, loss
    for x in leaves:
        x.requires_grad_(False)
    del m, v
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms(params, initial),
            "sizes": {p: params[p].numel() for p in paths}}


@torch.no_grad()
def change_norms(params: dict, initial) -> dict:
    """{path: ||params[path] - its starting value||}, a group at a time."""
    from gpubench.weights import group_of

    out = {}
    for group in sorted({group_of(p) for p in params}):
        start = initial(group)
        for path, p0 in start.items():
            out[path] = torch.linalg.vector_norm(params[path].detach() - p0).item()
        del start
    return out
