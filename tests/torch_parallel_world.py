"""The port's meshed functions on a 4-rank world, the other side of
``tests/test_torch_parallel.py``: ``python tests/torch_parallel_world.py
INPUTS_NPZ OUT_PKL [cpu|cuda]``.

Every rank starts from the reference's parameters and inputs in
``INPUTS_NPZ`` (written by ``tests/jax_parallel_oracle.py``) and runs every
case -- the meshed train steps, the dense decodes, zamba2's, the xLSTM's,
Whisper's and dbrx-132b's (the MoE's) decodes, and dbrx-132b's also on a
(1, 4) mesh -- on a (2, 2) ``data x model`` DeviceMesh (the pipeline and the
compressed mean on the world's 4 ranks); rank 0's results go to ``OUT_PKL``.
The world is gloo on the CPU (the default) or NCCL on 4 cards, rank r on
``cuda:r``, where the meshed step's kernels run on the local shards and the
kernels' launches of each train run are recorded.
"""

import dataclasses
import os
import pickle
import sys

import numpy as np
import torch

TRAIN_ARCHS = ("minicpm-2b", "qwen3-moe-235b-a22b", "zamba2-2.7b", "glm4-9b", "dbrx-132b")
SEQ, BATCH, STEPS, LR = 16, 8, 3, 1e-3
DECODE_B, DECODE_L, DECODE_TOKENS = 4, 32, 5
# the recurrent, encoder-decoder and MoE families' meshed decodes (Whisper's over
# DECODE_FRAMES encoder frames)
DECODE_ARCHS = ("zamba2-2.7b", "xlstm-350m", "whisper-tiny", "dbrx-132b")
DECODE_FRAMES = 24


def decode_config(n_kv_heads: int = 3):
    """The reference test's seq-sharded decode config: 3 KV heads, which a
    ``model`` dimension of 2 does not divide (2 KV heads: the head-sharded
    decode)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("glm4-9b").reduced(), n_heads=6,
                               n_kv_heads=n_kv_heads, d_model=96, head_dim=16)


def unflatten(inputs, prefix: str) -> dict:
    tree: dict = {}
    for key in inputs.files:
        name, _, path = key.partition("|")
        if name != prefix:
            continue
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = inputs[key]
    return tree


def expected_local(shape, spec, sizes) -> tuple:
    out = []
    for dim, entry in zip(shape, spec):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        for n in names:
            dim //= sizes[n]
        out.append(dim)
    return tuple(out)


def train_case(inputs, arch, mesh, dev) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_params
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import make_train_step

    cfg = get_config(arch).reduced()
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="float32",
                                          remat=False), device=dev)
    tree = unflatten(inputs, arch)
    ds = SyntheticDataset(cfg.vocab, SEQ, BATCH)
    opt = AdamWConfig(lr=LR)
    out = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        params = from_jax_params(tree, cfg, device=dev, mesh=m)
        state = init_opt_state(params)
        step = make_train_step(model, opt, mesh=m)
        losses = []
        ops.reset_launch_counts()
        for i in range(STEPS):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in ds.batch(i).items()}
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
        out[name] = losses
        out[f"{name}_launches"] = ops.launch_counts()
    # every leaf a local shard of the shape its spec implies, the moments too
    sizes = shd.mesh_shape(mesh)
    wrong = []
    for kind, tree_, spec_fn in (("param", params, shd.param_spec),
                                 ("m", state["m"], shd.opt_spec), ("v", state["v"], shd.opt_spec)):
        def check(path, leaf):
            spec = spec_fn(path, leaf.shape, mesh)
            want = expected_local(leaf.shape, spec, sizes)
            if not isinstance(leaf, DTensor) or tuple(leaf.to_local().shape) != want \
                    or tuple(leaf.placements) != shd.to_placements(spec, mesh):
                wrong.append((kind, path, tuple(leaf.shape), spec))
        shd.map_with_path(check, tree_)
    out["wrong_layouts"] = wrong
    out["sharded_leaves"] = sum(
        1 for leaf in tree_leaves(params) if leaf.to_local().numel() < leaf.numel())
    first = params["layers"][0]
    leaf = first["attn"]["wq"] if "attn" in first else first["ssm"]["w_in"]
    out["first_leaf"] = (tuple(leaf.shape), tuple(leaf.to_local().shape))
    return out


#: the models whose gathers of one remat train step are counted leaf by leaf:
#: tied embeddings, the hybrid's shared block, the MoE's expert stacks
GATHER_ARCHS = ("minicpm-2b", "zamba2-2.7b", "dbrx-132b")


def gather_case(arch, mesh, dev) -> dict:
    """Two meshed train steps of a reduced model under remat (fp32, the port's
    init, laid out by the first step) and two unmeshed ones from the same init:
    both runs' losses; in the second meshed step, how many times each
    parameter leaf is gathered (``DTensor.redistribute`` of the leaf itself
    from a shard to a replica on some mesh dimension, which only
    ``parallel.sharding.gather_at_use`` does: AdamW's update cuts a replicated
    leaf to its moments' shards), and which leaves are sharded over
    ``data``."""
    from collections import Counter

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import make_train_step

    cfg = get_config(arch).reduced()
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="float32",
                                          remat=True), device=dev)
    ds = SyntheticDataset(cfg.vocab, SEQ, BATCH)
    losses = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        params = model.init(torch.Generator(dev).manual_seed(0))
        step = make_train_step(model, AdamWConfig(lr=LR), mesh=m)
        params, state, metrics = step(params, init_opt_state(params), ds.batch(0))
        losses[name] = [float(metrics["loss"])]
        if m is None:
            losses[name].append(float(step(params, state, ds.batch(1))[2]["loss"]))
    leaves = dict(_flat(params))
    paths = {id(t): path for path, t in leaves.items()}
    gathered: Counter = Counter()
    redistribute = DTensor.redistribute

    def counting(self, *args, **kwargs):
        to = kwargs.get("placements", args[1] if len(args) > 1 else None) or self.placements
        if id(self) in paths and any(isinstance(a, Shard) and isinstance(b, Replicate)
                                     for a, b in zip(self.placements, to)):
            gathered[paths[id(self)]] += 1
        return redistribute(self, *args, **kwargs)

    DTensor.redistribute = counting
    try:
        losses["mesh"].append(float(step(params, state, ds.batch(1))[2]["loss"]))
    finally:
        DTensor.redistribute = redistribute
    data = list(shd.mesh_shape(mesh)).index("data")
    return {**losses, "gathers": dict(gathered), "leaves": sorted(leaves),
            "data_sharded": sorted(p for p, t in leaves.items()
                                   if isinstance(t.placements[data], Shard)),
            "tied": cfg.tie_embeddings}


def expected_gathers(case: dict) -> dict:
    """The gathers ``gather_case`` must count, leaf by leaf: a layer's leaves
    sharded over ``data`` twice (the forward and the recompute of the layer's
    checkpoint), the hybrid's shared block once (gathered at the top of the
    forward, outside the checkpoints), the embedding and the head once at each
    use (a tied table at the lookup and at the logits), a leaf not sharded
    over ``data`` never."""
    sharded = set(case["data_sharded"])

    def times(path: str) -> int:
        if path not in sharded:
            return 0
        if path.startswith("layers/"):
            return 2
        return 2 if path == "embed/tokens" and case["tied"] else 1

    return {p: times(p) for p in case["leaves"] if times(p)}


def trainer_case(mesh, dev, ckpt_dir: str) -> dict:
    """Reduced glm4-9b (4 q heads on 2 KV heads: one a rank on ``model``)
    through the launcher's meshed recipe -- fp32 masters, bf16 compute -- on
    the mesh: the state ``Trainer._init_state`` makes in its layout, gathered,
    against ``model.init`` of the same seed; the trainer's losses (that state,
    a save at the last step) against the same meshed step fed the whole-tree
    init, which it lays out on its first call; the host copies each rank's
    ``_to_host`` made in the save; and the checkpoint restored into the layout
    against the whole-tree run's final state."""
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import Trainer, TrainerConfig, make_train_step

    cfg = get_config("glm4-9b").reduced()
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="bfloat16",
                                          remat=False), device=dev)
    ds = SyntheticDataset(cfg.vocab, SEQ, BATCH)
    opt = AdamWConfig(lr=LR)
    trainer = Trainer(model, ds, opt, ckpt_dir,
                      TrainerConfig(total_steps=STEPS, ckpt_every=STEPS, log_every=1))
    trainer.step_fn = make_train_step(model, opt, mesh=mesh)
    layouts = trainer.step_fn.state_shardings
    out = {}

    def paths_where(test, *trees) -> list[str]:
        flat = [dict(_flat(t)) for t in trees]
        return [path for path in flat[0] if not test(*(f[path] for f in flat))]

    params, state = trainer._init_state()
    whole = model.init(torch.Generator(dev).manual_seed(0))
    lay = layouts(whole)
    out["init_not_bitwise"] = paths_where(lambda a, b: torch.equal(shd.full_tensor(a), b),
                                          params, whole)
    out["init_wrong_layouts"] = paths_where(
        lambda a, s: shd.is_dtensor(a) and tuple(a.placements) == s.placements,
        params, lay["params"])
    out["moments_wrong"] = [
        (k, p) for k in ("m", "v") for p in paths_where(
            lambda a, s: shd.is_dtensor(a) and tuple(a.placements) == s.placements
            and a.dtype == torch.float32 and not a.to_local().any(), state[k], lay["opt"][k])]
    del params, state

    kept = []
    to_host = checkpointer._to_host

    def recording(leaf, keep=True):
        arr, name = to_host(leaf, keep)
        if isinstance(leaf, torch.Tensor):
            kept.append(0 if arr is None else arr.nbytes)
        return arr, name

    checkpointer._to_host = recording
    try:
        trainer.run()
    finally:
        checkpointer._to_host = to_host
    out["sharded_init"] = trainer.losses()
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, kept)
    out["host_bytes_by_rank"] = [sum(k) for k in per_rank]
    out["host_copies_by_rank"] = [sum(1 for b in k if b) for k in per_rank]
    out["leaves"] = len(kept)

    step = make_train_step(model, opt, mesh=mesh)
    p, s = whole, init_opt_state(whole)
    losses = []
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in ds.batch(i).items()}
        p, s, metrics = step(p, s, batch)
        losses.append(float(metrics["loss"]))
    out["whole_init"] = losses

    rp, rs, start = trainer._restore_or_init()
    out["restored_step"] = (start, rs["step"])
    out["restore_not_bitwise"] = paths_where(
        lambda a, b: torch.equal(shd.full_tensor(a), shd.full_tensor(b)),
        {"params": rp, "m": rs["m"], "v": rs["v"]}, {"params": p, "m": s["m"], "v": s["v"]})
    out["restore_wrong_layouts"] = paths_where(
        lambda a, b: tuple(a.placements) == tuple(b.placements),
        {"params": rp, "m": rs["m"]}, {"params": p, "m": s["m"]})
    return out


def _flat(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def decode_case(inputs, mesh, dev, n_kv_heads: int = 3) -> dict:
    """Dense decode, unmeshed and through ``make_serve_step``: from the
    inputs' weights for 3 KV heads, from the port's init for 2."""
    from repro_torch.convert import from_jax_params
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.models.layers import seq_sharded_decode
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.train_step import make_serve_step

    cfg = decode_config(n_kv_heads)
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="float32",
                                          remat=False), device=dev)
    toks = [torch.full((DECODE_B, 1), t % cfg.vocab, dtype=torch.int32, device=dev)
            for t in range(DECODE_TOKENS)]
    if n_kv_heads == 3:
        tree = unflatten(inputs, "decode")
        params = from_jax_params(tree, cfg, device=dev)
        meshed_params = from_jax_params(tree, cfg, device=dev, mesh=mesh)
    else:
        params = model.init(torch.Generator(dev).manual_seed(0))
        meshed_params = params
    cache = model.init_cache(DECODE_B, DECODE_L)
    plain = []
    for t in toks:
        lg, cache = model.decode_step(params, cache, t)
        plain.append(lg.cpu().numpy())
    step = make_serve_step(model, mesh)
    params, cache = step.lay_out(meshed_params, model.init_cache(DECODE_B, DECODE_L))
    meshed = []
    for t in toks:
        lg, cache = step(params, cache, t)
        meshed.append(lg.full_tensor().cpu().numpy())
    with shd.activate(mesh):
        branch = seq_sharded_decode(cfg.n_kv_heads, DECODE_L)
    k = cache["kv"]["k"]
    return {"plain": np.stack(plain), "mesh": np.stack(meshed), "seq_sharded": branch,
            "cache_spec": shd.from_placements(k.placements, mesh, k.ndim),
            "cache_local": tuple(k.to_local().shape)}


def family_decode_case(inputs, arch, mesh, dev) -> dict:
    """zamba2's, the xLSTM's, Whisper's and dbrx-132b's decode (reduced configs, fp32, the
    inputs' weights), unmeshed and through ``make_serve_step``: the logits of
    DECODE_TOKENS steps, and the leaves of the meshed cache whose layout is not
    ``cache_shardings``' (the recurrent states written back on every rank's
    shard)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_params
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.train_step import cache_shardings, make_serve_step

    cfg = get_config(arch).reduced()
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="float32",
                                          remat=False), device=dev)
    tree = unflatten(inputs, arch)
    params = from_jax_params(tree, cfg, device=dev)

    def fresh_cache():   # Whisper's: the encoder's K/V put in by prefill_cross
        if cfg.family != "audio":
            return model.init_cache(DECODE_B, DECODE_L)
        frames = torch.from_numpy(inputs["frames"]).to(dev)
        return model.prefill_cross(params, model.init_cache(DECODE_B, DECODE_L, DECODE_FRAMES),
                                   frames)

    toks = [torch.full((DECODE_B, 1), t % cfg.vocab, dtype=torch.int32, device=dev)
            for t in range(DECODE_TOKENS)]
    out = {}
    for name, step in (("plain", model.decode_step), ("mesh", make_serve_step(model, mesh))):
        p, cache = params, fresh_cache()
        if name == "mesh":
            p, cache = step.lay_out(from_jax_params(tree, cfg, device=dev, mesh=mesh), cache)
        logits = []
        for t in toks:
            lg, cache = step(p, cache, t)
            logits.append(shd.full_tensor(lg).cpu().numpy())
        out[name] = np.stack(logits)
    specs, wrong = {}, []

    def check(leaf, sharding, path):
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                check(v, sharding[k], f"{path}{k}/")
        elif isinstance(leaf, torch.Tensor):
            specs[path[:-1]] = shd.from_placements(leaf.placements, mesh, leaf.ndim)
            if tuple(leaf.placements) != sharding.placements:
                wrong.append((path[:-1], specs[path[:-1]], sharding.spec))

    check(cache, cache_shardings(cache, mesh, model=model), "")
    out["cache_specs"], out["wrong_layouts"] = specs, wrong
    return out


def pipeline_case(inputs, dev) -> dict:
    import torch.distributed as dist

    from repro_torch.parallel import pipeline as pp

    rank = dist.get_rank()
    dist.barrier()   # NCCL: the world's first collective has every rank in it
    W = torch.from_numpy(inputs["pp_W"][rank]).to(dev).requires_grad_(True)
    x = torch.from_numpy(inputs["pp_x"]).to(dev)
    pp.sent_bytes.clear()
    y = pp.pipeline_forward(lambda w, h: torch.tanh(h @ w), 4)(W, x)
    (y ** 2).sum().backward()
    grads = [torch.zeros_like(W) for _ in range(4)]
    dist.all_gather(grads, W.grad)
    sent = [None] * 4
    dist.all_gather_object(sent, dict(pp.sent_bytes))
    return {"y": y.detach().cpu().numpy(), "grad": torch.stack(grads).cpu().numpy(), "sent": sent}


def collectives_case(inputs, mesh, dev) -> dict:
    import torch.distributed as dist

    from repro_torch.parallel.collectives import compressed_psum_mean, make_dp_grad_fn

    xs = torch.from_numpy(inputs["cc_x"]).to(dev)
    out = {s: compressed_psum_mean({"g": xs[dist.get_rank()]}, None, s)["g"].cpu().numpy()
           for s in ("fp16", "int8")}
    out["exact"] = xs.mean(0).cpu().numpy()
    # data-parallel value-and-grad over mesh's data dimension against one process
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)).to(dev)
    batch = {"x": torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)).to(dev),
             "y": torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32)).to(dev)}
    loss_fn = lambda p, b: (((b["x"] @ p["w"]) - b["y"]).square().mean(), {})
    loss, grads = make_dp_grad_fn(loss_fn, mesh, "data", "fp16")({"w": w}, batch)
    wr = w.clone().requires_grad_(True)
    ref = loss_fn({"w": wr}, batch)[0]
    ref.backward()
    out["dp"] = (float(loss), float(ref.detach()), float((grads["w"] - wr.grad).abs().max()))
    return out


def world(rank: int, inputs_path: str, device_type: str = "cpu"):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda":   # fp32 products stay full fp32, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    inputs = np.load(inputs_path)
    mesh = init_device_mesh(device_type, (2, 2), mesh_dim_names=("data", "model"))
    out = {f"train|{arch}": train_case(inputs, arch, mesh, dev) for arch in TRAIN_ARCHS}
    for arch in GATHER_ARCHS:
        out[f"gathers|{arch}"] = gather_case(arch, mesh, dev)
    out["trainer"] = trainer_case(mesh, dev, os.path.join(os.path.dirname(inputs_path),
                                                          "trainer_ckpt"))
    out["decode"] = decode_case(inputs, mesh, dev)
    out["decode_heads"] = decode_case(inputs, mesh, dev, n_kv_heads=2)
    for arch in DECODE_ARCHS:
        out[f"decode|{arch}"] = family_decode_case(inputs, arch, mesh, dev)
    # the MoE's experts and heads over a 4-way model dimension, nothing gathered
    wide = init_device_mesh(device_type, (1, 4), mesh_dim_names=("data", "model"))
    out["decode_1x4|dbrx-132b"] = family_decode_case(inputs, "dbrx-132b", wide, dev)
    out["pipeline"] = pipeline_case(inputs, dev)
    out["collectives"] = collectives_case(inputs, mesh, dev)
    return out if rank == 0 else None


if __name__ == "__main__":
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent))
    from repro_torch.launch.mesh import spawn

    from torch_parallel_world import world as world_fn   # importable by name in the ranks

    device_type = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    result = spawn(world_fn, 4, device_type, (sys.argv[1], device_type))[0]
    with open(sys.argv[2], "wb") as f:
        pickle.dump(result, f)
