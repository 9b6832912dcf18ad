"""Weights from the seed, made on the device in fp32 (the masters' dtype), a
few large draws: one ``randn`` a group (a layer, the embedding, the head, the
shared block), on a generator seeded from (seed, group), so that any group can
be drawn again alone and bit for bit, by the reference or by the check of the
parameters' change.  A group's leaves are views of its one buffer.

Each leaf's values come from its kind, read off its name as the models' own
initialisers set them: a 2-D weight ``x @ W`` is N(0, 1/fan_in) with
``fan_in = shape[0]``, a norm scale and Mamba2's ``D`` are ones, ``A_log`` is
log(1 .. H), ``dt_bias`` is log(expm1(0.01)) and the conv window N(0, 0.01).
"""

from __future__ import annotations

import math

import torch


def group_of(path: str) -> str:
    parts = path.split(".")
    return ".".join(parts[:2]) if parts[0] == "layers" else parts[0]


def groups(spec: dict) -> dict:
    """{group: [(path, shape), ...]} in a fixed order (paths sorted)."""
    out: dict = {}
    for path in sorted(spec):
        out.setdefault(group_of(path), []).append((path, tuple(spec[path])))
    return out


def _generator(seed: int, group_index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + group_index) % 2**63)


def _fill(path: str, leaf: torch.Tensor) -> None:
    name = path.split(".")[-1]
    if name in ("norm_scale", "D"):
        leaf.fill_(1.0)
    elif name == "A_log":
        leaf.copy_(torch.log(torch.linspace(1.0, float(leaf.numel()), leaf.numel())))
    elif name == "dt_bias":
        leaf.fill_(math.log(math.expm1(0.01)))
    elif name == "conv_w":
        leaf.mul_(0.1)
    elif leaf.dim() == 2:
        leaf.mul_(1.0 / math.sqrt(leaf.shape[0]))
    else:
        raise ValueError(f"no initial value for a leaf named {path!r} of shape {tuple(leaf.shape)}")


def make_group(spec: dict, seed: int, group: str, device) -> dict:
    """{path: fp32 tensor} of one group, views of one buffer."""
    order = list(groups(spec))
    leaves = groups(spec)[group]
    sizes = [math.prod(shape) for _, shape in leaves]
    buf = torch.randn(sum(sizes), generator=_generator(seed, order.index(group), device),
                      device=device, dtype=torch.float32)
    out = {}
    for (path, shape), part in zip(leaves, torch.split(buf, sizes)):
        leaf = part.view(shape)
        _fill(path, leaf)
        out[path] = leaf
    return out


def make(spec: dict, seed: int, device) -> dict:
    """{path: fp32 tensor} of every leaf of ``spec`` ({path: shape})."""
    out = {}
    for group in groups(spec):
        out.update(make_group(spec, seed, group, device))
    return out


def flatten(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in flatten(sub, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree) for p, v in flatten(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def tree(made: dict):
    """The tree of dicts and lists (a component of digits is a list index)
    whose dotted paths are ``made``'s keys, the models' parameter layout."""
    root: dict = {}
    for path, leaf in made.items():
        node, parts = root, path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
