"""Pipeline parallelism over a process group (GPipe schedule), the
reference's ``parallel/pipeline.py`` in ``torch.distributed`` terms.

This realizes the PP dimension of the comm matrix: rank ``i`` of the stage
group runs stage ``i``; microbatches stream through ``m + S - 1`` ticks of
compute and a boundary exchange (stage ``i`` sends to ``i + 1``); autograd
through the ticks gives the backward pipeline, each exchange's backward
being the reverse exchange -- a forward-all/backward-all GPipe with bubble
fraction (S-1)/(m+S-1).  An exchange moves only the ticks that carry a
microbatch (stage ``i``'s output at ticks ``i .. i + m - 1``), so the bytes
across one boundary per step, forward and backward, are exactly the paper's
Eq. 13 PP volume (:func:`pp_boundary_bytes`).
"""

from __future__ import annotations

from typing import Callable

import torch

#: bytes this process sent to each stage: {destination stage: bytes}
sent_bytes: dict[int, int] = {}


def _exchange(y: torch.Tensor, stage: int, n_stages: int, send: bool, recv: bool,
              group, ranks: list[int]) -> torch.Tensor:
    """Send ``y`` to stage + 1 when ``send``, receive from stage - 1 when
    ``recv`` (zeros otherwise), both posted before either is waited on."""
    import torch.distributed as dist

    ops, out = [], torch.zeros_like(y)
    if send:
        ops.append(dist.P2POp(dist.isend, y.contiguous(), ranks[stage + 1], group))
        sent_bytes[stage + 1] = sent_bytes.get(stage + 1, 0) + y.numel() * y.element_size()
    if recv:
        ops.append(dist.P2POp(dist.irecv, out, ranks[stage - 1], group))
    for req in dist.batch_isend_irecv(ops) if ops else []:
        req.wait()
    return out


def _exchange_back(g: torch.Tensor, stage: int, send: bool, recv: bool, group,
                   ranks: list[int]) -> torch.Tensor:
    """The reverse exchange: the gradient of what came from stage - 1 goes
    back to it, the gradient of what went to stage + 1 comes back."""
    import torch.distributed as dist

    ops, out = [], torch.zeros_like(g)
    if send:
        ops.append(dist.P2POp(dist.isend, g.contiguous(), ranks[stage - 1], group))
        sent_bytes[stage - 1] = sent_bytes.get(stage - 1, 0) + g.numel() * g.element_size()
    if recv:
        ops.append(dist.P2POp(dist.irecv, out, ranks[stage + 1], group))
    for req in dist.batch_isend_irecv(ops) if ops else []:
        req.wait()
    return out


class _Boundary(torch.autograd.Function):
    """One tick's boundary exchange; its backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, y, stage, n_stages, t, m, group, ranks):
        send = stage < n_stages - 1 and stage <= t < stage + m
        recv = stage > 0 and stage - 1 <= t < stage - 1 + m
        ctx.args = (stage, send, recv, group, ranks)
        return _exchange(y, stage, n_stages, send, recv, group, ranks)

    @staticmethod
    def backward(ctx, g):
        stage, send, recv, group, ranks = ctx.args
        # forward received -> backward sends; forward sent -> backward receives
        return _exchange_back(g, stage, recv, send, group, ranks), None, None, None, None, None, None


class _MaskedSum(torch.autograd.Function):
    """All-reduce (sum) over the stage group.  The result is the same on
    every rank and so is its cotangent, which counts once: the backward is
    the all-reduce again, divided by the group size (the reference's
    shard_map divides a replicated output's cotangent by the axis size
    before ``psum``'s transpose, which is ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def pipeline_forward(stage_fn: Callable, n_stages: int, group=None):
    """Build ``fn(stage_params, x_mb) -> y`` to be called on every rank of
    ``group`` (size ``n_stages``; rank i of the group is stage i) with that
    stage's parameters.  ``x_mb``: (m, mb, ...) microbatches, the same on every
    stage (stage 0 consumes them); returns (m, mb, ...) outputs on every
    stage (the last stage's, broadcast by a masked all-reduce)."""
    import torch.distributed as dist

    def fn(stage_params, x_mb: torch.Tensor) -> torch.Tensor:
        stage = dist.get_rank(group)
        ranks = dist.get_process_group_ranks(group) if group is not None else \
            list(range(dist.get_world_size()))
        if len(ranks) != n_stages:
            raise ValueError(f"{n_stages} stages on a group of {len(ranks)} ranks")
        m = x_mb.shape[0]
        first, last = stage == 0, stage == n_stages - 1
        buf = torch.zeros_like(x_mb[0])
        outs = []
        for t in range(m + n_stages - 1):
            x_in = torch.where(torch.tensor(first), x_mb[min(t, m - 1)], buf)
            y = stage_fn(stage_params, x_in)
            if t >= n_stages - 1:   # the last stage's output for microbatch t - (S - 1)
                outs.append(y)
            buf = _Boundary.apply(y, stage, n_stages, t, m, group, ranks)
        mine = torch.where(torch.tensor(last), torch.stack(outs), torch.zeros_like(x_mb))
        return _MaskedSum.apply(mine, group)

    return fn


def make_pp_loss_fn(embed_fn: Callable, stage_fn: Callable, head_loss_fn: Callable,
                    n_stages: int, group=None):
    """End-to-end pipelined loss: ``loss(params, batch)`` on every rank of
    ``group``, ``params = {"stage": this stage's parameters, "shared": the
    rest, the same on every rank}``; ``embed_fn(shared, batch) -> x0`` (m, mb,
    s, d), ``head_loss_fn(shared, y, batch) -> scalar``.  The loss is the same
    on every rank; the gradient of ``shared`` is whole on stage 0 (the
    embedding's part reaches only the stage that ingests the microbatches)."""
    pipe = pipeline_forward(stage_fn, n_stages, group)

    def loss(params, batch):
        x0 = embed_fn(params["shared"], batch)
        y = pipe(params["stage"], x0)
        return head_loss_fn(params["shared"], y, batch)

    return loss


def pp_boundary_bytes(mb: int, seq: int, d_model: int, n_microbatches: int,
                      bytes_per_el: int = 2) -> int:
    """Eq. 13 check: bytes crossing one PP boundary per step (fwd + bwd)."""
    return 2 * mb * seq * d_model * n_microbatches * bytes_per_el
