"""Logical-axis sharding rules (DP/TP/EP/SP) for the production meshes, the
reference's ``parallel/sharding.py`` in ``torch.distributed.tensor`` terms.

Models annotate activations with *logical* axis names via :func:`lshard`
(e.g. ``lshard(x, "batch", "seq", "embed")``); a rule table maps logical
names to mesh dimensions.  Rules are resolved *shape-aware*: a mapping that
does not divide the dimension evenly (2 KV heads over a 16-way ``model``
dimension) degrades to replication for that dimension instead of failing, so
one rule table serves every architecture.

A spec is a plain tuple with one entry per tensor dimension: ``None``, a mesh
dimension's name, or a tuple of names -- the contents of the reference's
``PartitionSpec``.  :func:`to_placements` turns it into the per-mesh-dimension
DTensor placements: a tensor dimension under ``("pod", "data")`` is
``Shard(d)`` on both mesh dimensions, the major one first.

Parameter sharding is path-based (:func:`param_spec`): attention/FFN weights
are tensor-parallel over ``model``, expert stacks expert-parallel over
``model``, embeddings and the LM head vocab-parallel, and the largest
remaining replicated dimension is sharded over the data dimensions (ZeRO-3);
the optimizer moments take the same spec plus any data dimension the
parameter leaves free (ZeRO-1, :func:`opt_spec`).  Paths are the port's
``/``-joined tree paths: a layer list contributes its index,
``layers/3/attn/wq``, where the reference's stacked trees have a leading
layer dimension instead.

The rules read only a mesh's dimension names and sizes, so a
:class:`~torch.distributed.device_mesh.DeviceMesh` and a plain ``{name:
size}`` mapping serve alike (the latter checks the production meshes in one
process).  The active mesh and rules live in a context (:func:`activate`);
without one, :func:`lshard` is a no-op and the models run as they do on one
device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Mapping, Optional, Sequence

import torch

from repro_torch.kernels.ops import is_dtensor  # noqa: F401  (shd.is_dtensor)


# ---------------------------------------------------------------------------
# Rule tables.  Values are mesh-dimension names or tuples of them.
# ---------------------------------------------------------------------------

def default_rules(mesh_axes: Sequence[str], sequence_parallel: bool = False) -> dict:
    data_axes = tuple(a for a in ("pod", "data") if a in mesh_axes)
    rules = {
        "batch": data_axes,                # DP over pod x data
        "seq": (),                         # replicated (SP overrides)
        "seq_sp": (),                      # residual-stream seq (Megatron SP)
        "embed": (),                       # activations replicated on d_model
        "heads": ("model",),               # TP over attention heads
        "kv_heads": ("model",),            # degrades to replicate if indivisible
        "head_dim": (),
        "ffn": ("model",),                 # TP over FFN hidden
        "experts": ("model",),             # EP over expert stack
        "expert_ff": (),                   # per-expert hidden stays local
        "vocab": ("model",),               # vocab-parallel embeddings/logits
        "ssm_heads": ("model",),
        "ssm_state": (),
        "zero": data_axes,                 # ZeRO-1 optimizer-state axis
        "fsdp": data_axes,                 # ZeRO-3 weight sharding over DP; () disables
        "stage": (),                       # pipeline stage (pipeline.py only)
    }
    if sequence_parallel:
        rules["seq"] = ("model",)
    return rules


def mesh_shape(mesh) -> dict[str, int]:
    """{dimension name: size} of a DeviceMesh, in mesh order, or ``mesh``
    itself when it already is such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(_device_mesh_shape(mesh))


@functools.lru_cache(maxsize=64)
def _device_mesh_shape(mesh) -> tuple:
    return tuple((name, mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names))


class _Ctx:
    """The active mesh and rules, for every thread of the process: a CUDA
    backward, and with it each remat recompute (where a layer gathers its
    ZeRO-3 weights and lays its activations out again), runs on autograd's
    device thread, not on the thread that entered :func:`activate`."""

    mesh = None
    rules: Optional[dict] = None


_CTX = _Ctx()


@contextlib.contextmanager
def activate(mesh, rules: Optional[dict] = None, sequence_parallel: bool = False):
    """Make ``mesh`` (a DeviceMesh) the active mesh of model code run in this
    context: :func:`lshard` and :func:`pshard` then lay DTensors out by it,
    and a plain tensor meeting a DTensor in an op counts as replicated (the
    positions, masks and constants the models make on the fly).  The active
    mesh is the whole process's (autograd's device thread reads it too), so
    one mesh may be active at a time: entering with another mesh while one is
    active raises, rather than lay out the other's tensors by it."""
    from torch.distributed.tensor.experimental import implicit_replication

    if _CTX.mesh is not None and _CTX.mesh is not mesh:
        raise RuntimeError("another mesh is active in this process: one mesh at a time")
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = rules or default_rules(tuple(mesh_shape(mesh)), sequence_parallel)
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def data_axis_names() -> tuple:
    if _CTX.mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh_shape(_CTX.mesh))


# ---------------------------------------------------------------------------
# Resolution: logical names -> spec, shape-aware.
# ---------------------------------------------------------------------------

def _axis_size(shape: Mapping[str, int], names) -> int:
    size = 1
    for n in names:
        size *= shape[n]
    return size


def resolve_spec(logical: Sequence[Optional[str]], shape: Sequence[int], mesh,
                 rules: dict) -> tuple:
    sizes = mesh_shape(mesh)
    parts = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        entry = rules.get(name, ()) if name else ()
        entry = tuple(e for e in (entry if isinstance(entry, tuple) else (entry,)) if e)
        entry = tuple(e for e in entry if e not in used)
        if entry and dim % _axis_size(sizes, entry) == 0 and dim > 0:
            parts.append(entry if len(entry) > 1 else entry[0])
            used.update(entry)
        else:
            parts.append(None)
    return tuple(parts)


def _entry_names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements, one per mesh dimension, of a spec: ``Shard(d)``
    on every mesh dimension that tensor dimension ``d``'s entry names,
    ``Replicate()`` on the others.  An entry naming several dimensions must
    name them in mesh order (major first), as DTensor shards them.  A mesh
    dimension of size 1 holds the whole tensor on its one rank: it is
    ``Replicate()`` whatever the spec (DTensor's view and sharding rules would
    otherwise treat the shard of one as a block to keep whole)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_names(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh dimension {names[i]!r} shards two tensor dims in {spec}")
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def from_placements(placements: Sequence, mesh, ndim: int) -> tuple:
    """The spec of DTensor placements (the inverse of :func:`to_placements`;
    a ``Partial`` reads as replicated)."""
    from torch.distributed.tensor import Shard

    parts: list[list[str]] = [[] for _ in range(ndim)]
    for name, p in zip(mesh_shape(mesh), placements):
        if isinstance(p, Shard):
            parts[p.dim % ndim].append(name)
    return tuple(None if not p else p[0] if len(p) == 1 else tuple(p) for p in parts)


def _pshard_spec(shape: Sequence[int], entries, sizes: Mapping[str, int]) -> tuple:
    parts = []
    used: set[str] = set()
    for dim, e in zip(shape, entries):
        names = tuple(a for a in ((e,) if isinstance(e, str) else (e or ()))
                      if a in sizes and a not in used)
        if names and dim % _axis_size(sizes, names) == 0 and dim > 0:
            parts.append(names if len(names) > 1 else names[0])
            used.update(names)
        else:
            parts.append(None)
    return tuple(parts)


def _redistribute(x, mesh, placements: tuple):
    """``x.redistribute(mesh, placements)``, reducing first each partial sum
    that does not become a shard on its own mesh dimension (DTensor's
    one-step path may apply a masked partial's mask to a block of another
    shape when another mesh dimension changes at the same time)."""
    from torch.distributed.tensor import Partial, Replicate

    current = tuple(x.placements)
    if current == tuple(placements):
        return x
    step = tuple(Replicate() if isinstance(c, Partial) and c != t else c
                 for c, t in zip(current, placements))
    if step != current:
        x = x.redistribute(mesh, step)
    return x.redistribute(mesh, placements)


def pshard(x: torch.Tensor, *entries) -> torch.Tensor:
    """Lay out with RAW mesh-dimension names (not logical); entries may be
    None, a name, or a tuple of names.  Shape-aware like :func:`lshard`: a
    non-dividing entry degrades to replication.  No-op without a mesh or for a
    plain tensor."""
    mesh = _CTX.mesh
    if mesh is None or not is_dtensor(x):
        return x
    spec = _pshard_spec(x.shape, entries, mesh_shape(mesh))
    return _redistribute(x, mesh, to_placements(spec, mesh))


def lshard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor activation to the layout its logical names
    resolve to (no-op when no mesh is active or ``x`` is a plain tensor, as
    on one device)."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or not is_dtensor(x):
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"lshard: {len(logical)} names for rank-{x.ndim} tensor")
    spec = resolve_spec(logical, x.shape, mesh, rules)
    return _redistribute(x, mesh, to_placements(spec, mesh))


# ---------------------------------------------------------------------------
# Parameter sharding: path-based rules.
# ---------------------------------------------------------------------------

#: path substring -> logical dim names (matched in order; first hit wins).
PARAM_RULES: list[tuple[str, tuple]] = [
    ("embed/tokens", ("vocab", None)),
    ("embed/pos", (None, None)),
    ("lm_head", (None, "vocab")),
    ("attn/wq", (None, "heads")),            # (d, H*hd) column-parallel
    ("attn/wk", (None, "kv_heads")),
    ("attn/wv", (None, "kv_heads")),
    ("attn/wo", ("heads", None)),            # row-parallel
    ("mlp/w_gate", (None, "ffn")),
    ("mlp/w_in", (None, "ffn")),
    ("mlp/w_out", ("ffn", None)),
    ("moe/router", (None, None)),
    ("moe/w_gate", ("experts", None, "expert_ff")),
    ("moe/w_in", ("experts", None, "expert_ff")),
    ("moe/w_out", ("experts", "expert_ff", None)),
    ("norm", (None,)),
    # xLSTM / Mamba2 projections: column-parallel in, row-parallel out
    ("ssm/w_in", (None, "ffn")),
    ("ssm/w_out", ("ffn", None)),
    ("ssm/", (None,)),                       # gates/biases: replicate
]


def logical_names_for(path_str: str, ndim: int) -> tuple:
    for frag, names in PARAM_RULES:
        if frag in path_str:
            if len(names) == ndim:
                return names
            if len(names) < ndim:
                # leading stacked dims: pad on the left
                return (None,) * (ndim - len(names)) + tuple(names)
            return tuple(names[-ndim:]) if ndim else ()
    return (None,) * ndim


def param_spec(path_str: str, shape: Sequence[int], mesh, rules: Optional[dict] = None) -> tuple:
    """TP/EP spec from the path rules, then ZeRO-3: the largest remaining
    replicated dim is sharded over the data dims (weights are all-gathered at
    use, gradients reduce-scattered -- the paper's DP volume v_d)."""
    sizes = mesh_shape(mesh)
    rules = rules or default_rules(tuple(sizes))
    base = resolve_spec(logical_names_for(path_str, len(shape)), shape, sizes, rules)
    fsdp_axes = tuple(rules.get("fsdp", ()) or ())
    if not fsdp_axes or "norm" in path_str or not shape:
        return base
    fsize = _axis_size(sizes, fsdp_axes)
    parts = list(base) + [None] * (len(shape) - len(base))
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if parts[i] is None and shape[i] % fsize == 0 and shape[i] >= fsize:
            parts[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
            return tuple(parts)
    return base


def opt_spec(path_str: str, shape: Sequence[int], mesh, rules: Optional[dict] = None) -> tuple:
    """ZeRO-1: the moments take the parameter's spec, then shard the largest
    still-replicated dim over any data dims the parameter's spec leaves free
    (with ZeRO-3 on, the parameter usually takes them all and the moments
    simply inherit its layout)."""
    sizes = mesh_shape(mesh)
    rules = rules or default_rules(tuple(sizes))
    base = param_spec(path_str, shape, sizes, rules)
    used = {a for part in base for a in _entry_names(part)}
    zero_axes = tuple(a for a in (rules.get("zero", ()) or ()) if a not in used)
    if not zero_axes:
        return base
    zsize = _axis_size(sizes, zero_axes)
    parts = list(base) + [None] * (len(shape) - len(base))
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if parts[i] is None and shape[i] % zsize == 0 and shape[i] > 0:
            parts[i] = zero_axes if len(zero_axes) > 1 else zero_axes[0]
            break
    return tuple(parts)


# ---------------------------------------------------------------------------
# Trees: shardings, and laying tensors out by them.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the reference's ``NamedSharding``."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, ``path`` the
    ``/``-joined keys and list indices."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix.rstrip("/"), tree)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", leaf))


def param_shardings(params, mesh, rules: Optional[dict] = None):
    """A tree of :class:`NamedSharding` for a tree of parameters (tensors, or
    anything with a ``shape``, or shape tuples)."""
    return map_with_path(lambda p, leaf: NamedSharding(mesh, param_spec(p, _shape(leaf), mesh, rules)),
                         params)


def opt_shardings(params, mesh, rules: Optional[dict] = None):
    return map_with_path(lambda p, leaf: NamedSharding(mesh, opt_spec(p, _shape(leaf), mesh, rules)),
                         params)


def local_chunk(full: torch.Tensor, mesh, placements: Sequence) -> torch.Tensor:
    """This rank's shard of a tensor every rank holds whole: the tensor
    narrowed mesh dimension by mesh dimension, in mesh order (major first).  A
    shard has a storage of its own, so the whole tensor can be freed; a tensor
    kept whole (replicated everywhere) is ``full`` itself."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    local = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            local = local.chunk(n, dim=p.dim)[coord[i]]
    return full if local is full else local.clone(memory_format=torch.contiguous_format)


def distribute(full: torch.Tensor, sharding: NamedSharding, device=None,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor every rank holds whole as a DTensor laid out by ``sharding``
    (no communication: each rank keeps its own chunk).  ``device``/``dtype``:
    where the chunk goes and what it is cast to once it is cut (a host
    tensor's shard goes to the card alone); ``full``'s by default."""
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding.mesh, sharding.placements
    local = local_chunk(full.detach(), mesh, placements).to(device=device or full.device,
                                                           dtype=dtype or full.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape,
                              stride=full.stride())


def zeros(shape: Sequence[int], sharding: NamedSharding, dtype: torch.dtype,
          device) -> torch.Tensor:
    """A DTensor of zeros of global ``shape`` laid out by ``sharding``: only
    this rank's shard is allocated."""
    from torch.distributed.tensor import DTensor, Shard

    mesh, placements = sharding.mesh, sharding.placements
    coord, local = mesh.get_coordinate(), list(shape)
    for i, p in enumerate(placements):   # local_chunk's pieces: torch.chunk's sizes
        if isinstance(p, Shard):
            n, step = local[p.dim], -(-local[p.dim] // mesh.size(i))
            local[p.dim] = max(0, min(step, n - coord[i] * step))
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, placements,
                              run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def lay_out(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``x`` laid out by ``sharding``: a DTensor is redistributed, a plain
    tensor (the same on every rank) distributed."""
    if is_dtensor(x):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute(x, sharding)


def local_offset(x, dim: int) -> int:
    """Where a DTensor's local shard starts along ``dim`` of the whole
    tensor (even shards; the mesh dimensions that shard ``dim`` taken major
    first); 0 for a plain tensor."""
    if not is_dtensor(x):
        return 0
    from torch.distributed.tensor import Shard

    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    block = 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
            block = block * mesh.size(i) + coord[i]
    return block * x.to_local().shape[dim]


def lay_out_tree(tree, shardings):
    """Every tensor leaf of ``tree`` laid out by the matching leaf of
    ``shardings``: a DTensor already in its layout is kept (the same leaf
    object, so in-place updates go on landing in it), any other tensor
    becomes a new leaf DTensor."""
    def one(leaf, sharding):
        if not isinstance(leaf, torch.Tensor) or sharding is None:
            return leaf
        if is_dtensor(leaf) and tuple(leaf.placements) == sharding.placements:
            return leaf
        return lay_out(leaf, sharding).detach()

    if isinstance(tree, dict):
        return {k: lay_out_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [lay_out_tree(v, s) for v, s in zip(tree, shardings, strict=True)]
    return one(tree, shardings)


def full_tensor(x):
    """A DTensor gathered whole on every rank; anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# ZeRO-3: weights gathered where they are used.
# ---------------------------------------------------------------------------

def _fsdp_dims() -> list[int]:
    """The active mesh's dimensions that the rules' ``fsdp`` names and that
    hold more than one rank."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return []
    fsdp = set(_entry_names(rules.get("fsdp") or None))
    return [i for i, (n, size) in enumerate(mesh_shape(mesh).items()) if n in fsdp and size > 1]


def gather_at_use(tree):
    """``tree`` (a tensor, or a dict/list tree of them) as the model computes
    with it: each DTensor leaf redistributed to ``Replicate()`` over the
    rules' ``fsdp`` dimensions -- ZeRO-3's all-gather at use, whose backward
    reduce-scatters the gradient into the leaf's layout.  The models call it
    at the top of each layer's body, inside the function that the layer's
    checkpoint wraps, and on the leaves outside the layers where each is used:
    a rank holds one layer's gathered weights at a time, the recompute gathers
    them again, and each layer's gradient is reduce-scattered as its backward
    ends.  The identity off a mesh, where ``fsdp`` is empty, and on a plain
    tensor."""
    dims = _fsdp_dims()
    if not dims:
        return tree
    from torch.distributed.tensor import Replicate

    mesh = _CTX.mesh

    def one(_, p):
        if not is_dtensor(p):
            return p
        pl = tuple(Replicate() if i in dims else q for i, q in enumerate(p.placements))
        return p if pl == tuple(p.placements) else p.redistribute(mesh, pl)

    return map_with_path(one, tree)
