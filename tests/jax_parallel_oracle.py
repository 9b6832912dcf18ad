"""The reference's meshed functions on fake host devices, the oracles of
``tests/test_torch_parallel.py``: ``python tests/jax_parallel_oracle.py OUT_DIR``.

Writes ``OUT_DIR/inputs.npz`` first (the reduced models' initial parameters,
the pipeline's and the compressed mean's inputs, Whisper's frames; the port's
ranks start from them), then ``OUT_DIR/oracle.npz``: the reference's meshed
train step (3 steps, fp32, on a (2, 2) ``data x model`` mesh) per model, its
seq-sharded decode, the meshed decodes of zamba2, the xLSTM, Whisper and dbrx-132b,
its GPipe forward and ``jax.grad`` of the pipelined loss, ``compressed_psum_mean``
over 4 devices, and the Arnold placement the launcher prints for
``--devices 4 --mesh-shape 2x2 --arnold --scheduler mip``.

Every mesh is made with ``AxisType.Auto`` axes: jax 0.9's ``make_mesh``
defaults to ``Explicit`` axes, on which ``with_sharding_constraint`` refuses
the reference's specs.  XLA compiles without its backend optimizations and
runs on one thread: the programs are tiny, and the compiles are the cost.
"""

import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 --xla_backend_optimization_level=0 "
                           "--xla_cpu_multi_thread_eigen=false")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, PartitionSpec as P  # noqa: E402

TRAIN_ARCHS = ("minicpm-2b", "qwen3-moe-235b-a22b", "zamba2-2.7b", "glm4-9b", "dbrx-132b")
SEQ, BATCH, STEPS, LR = 16, 8, 3, 1e-3
DECODE_B, DECODE_L, DECODE_TOKENS = 4, 32, 5
DECODE_ARCHS = ("zamba2-2.7b", "xlstm-350m", "whisper-tiny", "dbrx-132b")
DECODE_FRAMES = 24
S, M, MB, D = 4, 8, 2, 16          # the pipeline test's stages, microbatches, rows, width


def decode_config():
    from repro.configs import get_config

    return dataclasses.replace(get_config("glm4-9b").reduced(), n_heads=6, n_kv_heads=3,
                               d_model=96, head_dim=16)


def auto_mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[: math.prod(shape)])


def flat(prefix, tree, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[f"{prefix}|{key}"] = np.asarray(leaf, np.float32)


def main(out_dir: str) -> None:
    from jax import shard_map

    from repro.configs import get_config
    from repro.data import SyntheticDataset
    from repro.models import ModelOptions, build_model
    from repro.optim import AdamWConfig, init_opt_state
    from repro.parallel import sharding as shd
    from repro.parallel.collectives import compressed_psum_mean
    from repro.parallel.pipeline import pipeline_forward
    from repro.train import make_train_step
    from repro.train.train_step import cache_shardings

    opts = ModelOptions(compute_dtype="float32", remat=False)
    models, inputs = {}, {}
    for arch in dict.fromkeys(TRAIN_ARCHS + DECODE_ARCHS):
        cfg = get_config(arch).reduced()
        model = build_model(cfg, opts)
        models[arch] = (cfg, model, jax.jit(model.init)(jax.random.PRNGKey(0)))
        flat(arch, models[arch][2], inputs)
    dcfg = decode_config()
    dmodel = build_model(dcfg, opts)
    dparams = jax.jit(dmodel.init)(jax.random.PRNGKey(0))
    flat("decode", dparams, inputs)
    rng = np.random.default_rng(0)
    inputs["pp_W"] = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    inputs["pp_x"] = rng.standard_normal((M, MB, D)).astype(np.float32)
    inputs["cc_x"] = rng.standard_normal((4, 64)).astype(np.float32)
    inputs["frames"] = rng.standard_normal(
        (DECODE_B, DECODE_FRAMES, get_config("whisper-tiny").reduced().d_model)).astype(np.float32)
    np.savez(os.path.join(out_dir, ".inputs.npz"), **inputs)
    os.replace(os.path.join(out_dir, ".inputs.npz"), os.path.join(out_dir, "inputs.npz"))

    out = {}
    mesh = auto_mesh((2, 2), ("data", "model"))
    for arch in TRAIN_ARCHS:
        cfg, model, params = models[arch]
        ds = SyntheticDataset(cfg.vocab, SEQ, BATCH)
        state = jax.jit(init_opt_state)(params)
        losses = []
        with shd.activate(mesh):
            batch_shape = jax.eval_shape(lambda: {k: jnp.asarray(v) for k, v in ds.batch(0).items()})
            stepper = make_train_step(model, AdamWConfig(lr=LR), mesh=mesh, donate=False)
            fn = stepper(batch_shape)
            # laid out as the step returns them, so it compiles once
            params = jax.device_put(params, stepper.param_shardings)
            state = jax.device_put(state, stepper.opt_shardings)
            for i in range(STEPS):
                batch = {k: jnp.asarray(v) for k, v in ds.batch(i).items()}
                params, state, metrics = fn(params, state, batch)
                losses.append(float(metrics["loss"]))
        out[f"train|{arch}"] = np.asarray(losses)

    params = dparams
    toks = [jnp.full((DECODE_B, 1), t % dcfg.vocab, jnp.int32) for t in range(DECODE_TOKENS)]
    with shd.activate(mesh):
        p_sh = shd.param_shardings(jax.eval_shape(lambda: dmodel.init(jax.random.PRNGKey(0))), mesh)
        c_sh = cache_shardings(jax.eval_shape(lambda: dmodel.init_cache(DECODE_B, DECODE_L)),
                               mesh, model=dmodel)
        step = jax.jit(dmodel.decode_step, in_shardings=(p_sh, c_sh, None),
                       out_shardings=(None, c_sh))
        p2 = jax.device_put(params, p_sh)
        cache = jax.device_put(jax.jit(dmodel.init_cache, static_argnums=(0, 1))(
            DECODE_B, DECODE_L), c_sh)
        logits = []
        for t in toks:
            lg, cache = step(p2, cache, t)
            logits.append(np.asarray(lg, np.float32))
    out["decode"] = np.stack(logits)
    for arch in DECODE_ARCHS:
        out[f"decode|{arch}"] = family_decode(*models[arch], mesh, inputs["frames"])

    smesh = auto_mesh((S,), ("stage",))
    stage_fn = lambda W, x: jnp.tanh(x @ W)
    pipe = pipeline_forward(stage_fn, S, "stage")
    x = jnp.asarray(inputs["pp_x"])

    def run_pp(Ws):
        return shard_map(lambda Wl, x: pipe(Wl[0], x), mesh=smesh, in_specs=(P("stage"), P()),
                         out_specs=P(), check_vma=False)(Ws, x)

    Ws = jnp.asarray(inputs["pp_W"])
    out["pp_y"] = np.asarray(run_pp(Ws))
    out["pp_grad"] = np.asarray(jax.grad(lambda W: jnp.sum(run_pp(W) ** 2))(Ws))

    dmesh = auto_mesh((4,), ("data",))
    for scheme in ("fp16", "int8"):
        out[f"cc|{scheme}"] = np.asarray(shard_map(
            lambda v: compressed_psum_mean(v[0], "data", scheme), mesh=dmesh,
            in_specs=P("data"), out_specs=P(), check_vma=False)(jnp.asarray(inputs["cc_x"])))

    out["arnold"] = np.asarray(arnold())
    np.savez(os.path.join(out_dir, ".oracle.npz"), **out)
    os.replace(os.path.join(out_dir, ".oracle.npz"), os.path.join(out_dir, "oracle.npz"))


def family_decode(cfg, model, params, mesh, frames):
    """The reference's meshed decode of a reduced zamba2, xLSTM, Whisper or dbrx-132b
    (after ``prefill_cross`` of ``frames``): DECODE_TOKENS steps' logits."""
    from repro.parallel import sharding as shd
    from repro.train.train_step import cache_shardings

    if cfg.family == "audio":
        cache = jax.jit(model.prefill_cross)(
            params, model.init_cache(DECODE_B, DECODE_L, DECODE_FRAMES), jnp.asarray(frames))
    else:
        cache = model.init_cache(DECODE_B, DECODE_L)
    with shd.activate(mesh):
        p_sh = shd.param_shardings(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0))), mesh)
        c_sh = cache_shardings(jax.eval_shape(lambda: cache), mesh, model=model)
        step = jax.jit(model.decode_step, in_shardings=(p_sh, c_sh, None),
                       out_shardings=(None, c_sh))
        params, cache = jax.device_put(params, p_sh), jax.device_put(cache, c_sh)
        logits = []
        for t in range(DECODE_TOKENS):
            lg, cache = step(params, cache, jnp.full((DECODE_B, 1), t % cfg.vocab, jnp.int32))
            logits.append(np.asarray(lg, np.float32))
    return np.stack(logits)


def arnold():
    """(minipods used, spread of the data axis) of the reference's scheduling
    and Arnold-ordered mesh for the launcher's ``--devices 4 --mesh-shape 2x2
    --arnold --scheduler mip`` job on the reduced minicpm-2b, the job rounded
    up to one 8-GPU node (the reference's ``JobSpec`` is node-granular) and
    the mesh on its first 4 GPUs in logical order."""
    from types import SimpleNamespace

    from repro.configs import get_config
    from repro.core import (CharacterizationDB, Cluster, JobSpec, ModelSpec, ScheduleRequest,
                            build_comm_matrix, get_scheduler)
    from repro.core.rank_assign import device_permutation
    from repro.launch.mesh import mesh_group_spread

    cfg = get_config("minicpm-2b").reduced()
    cluster = Cluster.uniform(2, 4)
    mspec = ModelSpec(name=cfg.name, hidden=cfg.d_model, layers=cfg.n_layers, vocab=cfg.vocab,
                      seq_len=64, global_batch=8, d_ff=cfg.d_ff or 4 * cfg.d_model)
    job = JobSpec(n_gpus=8, tp=2, pp=1, model=mspec)
    comm = build_comm_matrix(job)
    alpha, beta, unit = CharacterizationDB().affinity_for(comm)
    res = get_scheduler("mip").schedule(ScheduleRequest(comm=comm, cluster=cluster, alpha=alpha,
                                                        beta=beta, unit=unit))
    perm = device_permutation(res.placement, job.tp)[:4]
    # the mesh as mesh_group_spread reads it: devices by physical id, axis names
    devices = np.asarray([SimpleNamespace(id=g) for g in perm], dtype=object).reshape(2, 2)
    mesh = SimpleNamespace(devices=devices, axis_names=("data", "model"))
    return res.n_pods_used(), mesh_group_spread(mesh, "data", 32)


if __name__ == "__main__":
    main(sys.argv[1])
