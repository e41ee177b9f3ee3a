"""The ``model`` axis of the port (tensor, sequence and expert
parallelism) against the JAX package.

* Four ranks: the JAX package on 4 fake CPU devices in three
  subprocesses (``JAX_PARTS``: the steps, the dense family's gradients,
  the MoE family's), the port on 4 gloo processes, all started
  together.  The port runs
  every case of ``CASES`` on ``data 2 x model 2`` (``launch.mesh.init_mesh``)
  or on ``model 4``, ``STEPS`` steps at lr 1e-3 from the same global
  parameters (drawn here with numpy) and the same global batches,
  computing in fp32, on the reduced ``tinyllama-1.1b`` (two kv heads, so
  ``model 4`` replicates them), ``qwen3-32b`` (qk-norm) and
  ``qwen2-moe-a2.7b``.
* The oracle (the JAX package's gradients at ``tp > 1`` are not those of
  its loss, see ``test_reference_tp_gradient_factors``): the JAX
  package's step at ``tp = 1`` on ``data 2`` with the same global weights
  and batches, for the loss, the grad norm, each leaf's gradient (step 0,
  before any aggregation, per data rank) and the parameters after the
  steps.  The MoE step without SP routes every token on every model rank
  and is the ``tp = 1`` function; with SP each model rank routes its own
  slice of the sequence with a capacity of its own, so its forward (loss
  and ``moe_aux`` per rank) is held against JAX's ``tp = 2`` forward, and
  its gradients against JAX's ``tp = 1`` step whose MoE layer runs once
  per sequence slice (the same routing), with the mean of the slices'
  load-balancing losses.  PowerSGD compresses each model rank's shard
  buckets, so its case holds the aggregated gradient of step 0 against
  JAX's ``GradAggregator.aggregate_bucketed`` on ``data 2 x model 2``
  over the same shard buckets of the ``tp = 1`` gradients (JAX's warm
  starts injected).
* On the same ranks: ``tp_copy``, ``tp_reduce`` (with and without SP)
  and ``tp_shared``, forward and backward, against JAX's under
  ``shard_map``; the vocabulary-parallel cross-entropy's loss and
  gradient against JAX's ``tp = 1`` function on the whole logits; the
  Adafactor update on TP shards against the unsharded one.
* Every case: the ranks with the same model index hold the same bits
  after the steps, and so do the leaves replicated over ``model`` on
  every rank; the overlapped cases' serial schedule gives the same bits.

Tolerances (fp32 compute): loss and grad norm ``rtol=1e-5`` (bf16
parameters: 1e-3); per-leaf gradients within ``1e-4`` of the leaf's
largest entry (the sums over ``model`` change the order of fp32 sums);
the aggregated PowerSGD gradient within ``1e-4`` of the bucket's
largest entry; parameters as ``test_torch_fsdp.py`` holds them (max
difference at most ``2 * lr * steps + 1e-4``, at most 2% of elements
beyond ``lr / 2``, median at most ``lr / 50``: Adam's sign-like update
moves near-zero gradients by up to ``lr`` either way); the f/g pairs:
exact over two ranks; the cross-entropy: ``1e-6`` relative.

This file is also the subprocess script: ``python test_torch_tp_step.py
jax DIR PART`` or ``python test_torch_tp_step.py torch DIR RANK PORT``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE, QK, MOE = "tinyllama-1.1b", "qwen3-32b", "qwen2-moe-a2.7b"
ARCHS = (DENSE, QK, MOE)
RANKS = 4
LR = 1e-3
STEPS = 2
GLOBAL_BATCH = 4             # 2 rows per data rank
SEQ = 16
BUCKET_MB = 0.0625
TIMEOUT_S = 300
SMALL_LEAF = 2048
COEF = 0.01                  # MOE_AUX_COEF of both packages

#: case -> (arch, tp, plan overrides beside dp_mode="ddp", JAX oracle run)
CASES = {
    "a-sp-zero1": (DENSE, 2, dict(zero1=True), "zero1"),
    "b-nosp-replicated": (DENSE, 2, dict(zero1=False, seq_parallel=False),
                          "repl"),
    "c-sp-replicated-overlap": (DENSE, 2, dict(zero1=False, overlap=True),
                                "repl"),
    "d-sp-zero1-powersgd-overlap": (DENSE, 2, dict(
        zero1=True, overlap=True, compression="powersgd"), None),
    "e-sp-replicated-powersgd": (DENSE, 2, dict(
        zero1=False, compression="powersgd"), "agg"),
    "f-sp-zero1-rtob": (DENSE, 2, dict(
        zero1=True, comm="reduce_to_owner_broadcast"), "zero1"),
    "g-fsdp-sp": (DENSE, 2, dict(dp_mode="fsdp", zero1=False), "repl"),
    "h-moe-nosp": (MOE, 2, dict(zero1=False, seq_parallel=False),
                   "moe-repl"),
    "i-moe-sp": (MOE, 2, dict(zero1=False), "moe-sp"),
    "j-model4-sp": (DENSE, 4, dict(zero1=False), "repl"),
    "k-qknorm-model4": (QK, 4, dict(zero1=False), "qk"),
}
#: the f/g pair checks: (op, seq_parallel, per-device input shape)
PAIRS = [("copy", False, (2, 4, 3)), ("copy", True, (2, 2, 3)),
         ("reduce", False, (2, 4, 3)), ("reduce", True, (2, 4, 3)),
         ("shared", False, (3, 5))]
XENT = (2, 4, 8)             # (B, S, V) of the cross-entropy check


def _reduced(cfgs, name):
    return cfgs.reduced(cfgs.get(name))


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _agg_layout_sizes():
    """Bucket sizes of the port's classic layout over the local shards
    of a rank of ``data 2 x model 2`` (fp32 parameters; no
    allocation)."""
    from repro_torch.configs import base as tcfgs
    from repro_torch.core import bucketing
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    model = Model(_reduced(tcfgs, DENSE), ShardCtx(tp=2, seq_parallel=True),
                  device="meta")
    return bucketing.layout_for(list(model.parameters()), BUCKET_MB).sizes


# ------------------------------------------------------------ the inputs
def _make_inputs(d):
    """in.npz: per arch the start parameters (global, fp32) and the
    global batches; the PowerSGD warm starts JAX's ``init_state`` draws
    for the shard buckets; the f/g pair and cross-entropy inputs."""
    import jax

    from repro.configs import base as jcfgs
    from repro.core.compression import base as jbase
    from repro.data.synthetic import DataConfig, batch_at
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_layout
    rng = np.random.default_rng(31)
    arrays = {}
    for name in ARCHS:
        cfg = _reduced(tcfgs, name)
        for leaf, shape, init in param_layout(cfg):
            arrays[f"param/{name}/{leaf}"] = (
                np.ones(shape) if init is None
                else init * np.clip(rng.standard_normal(shape), -3, 3)
            ).astype(np.float32)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                          global_batch=GLOBAL_BATCH)
        for s in range(STEPS):
            b = batch_at(dcfg, s)
            for k in ("tokens", "labels"):
                arrays[f"batch/{name}/{s}/{k}"] = b[k]
    plan = dataclasses.replace(_reduced(jcfgs, DENSE).plan,
                               compression="powersgd")
    comp = jbase.make(plan.compression, **jbase.plan_kwargs(plan))
    sizes = _agg_layout_sizes()
    keys = jax.random.split(jax.random.fold_in(jax.random.key(0), 7),
                            len(sizes))
    for i, (n, k) in enumerate(zip(sizes, keys)):
        arrays[f"q/{i}"] = np.asarray(comp.init_state(n, k).q)
    for i, (_, _, shape) in enumerate(PAIRS):
        arrays[f"px/{i}"] = rng.standard_normal((RANKS, *shape)).astype(
            np.float32)
        arrays[f"pct/{i}"] = rng.standard_normal(
            (RANKS, *_pair_out(PAIRS[i]))).astype(np.float32)
    arrays["xent/logits"] = rng.standard_normal(XENT).astype(np.float32)
    arrays["xent/labels"] = rng.integers(0, XENT[2], XENT[:2])
    arrays["xent/ct"] = rng.standard_normal(XENT[:2]).astype(np.float32)
    np.savez(os.path.join(d, "in.npz"), **arrays)


def _pair_out(pair):
    op, sp, shape = pair
    if op == "copy" and sp:
        return (shape[0], shape[1] * 2, *shape[2:])
    if op == "reduce" and sp:
        return (shape[0], shape[1] // 2, *shape[2:])
    return shape


def _start(inp, name):
    pre = f"param/{name}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def _batch(inp, name, step):
    pre = f"batch/{name}/{step}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


# ------------------------------------------------------------- JAX side
def _jax_setup(jts, mesh, name, **ov):
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    setup = jts.build(_reduced(jcfgs, name), mesh, bucket_mb=BUCKET_MB,
                      dp_mode="ddp", **ov)
    setup.ctx = dataclasses.replace(setup.ctx, compute_dtype=jnp.float32)
    return setup


def _jax_params(setup, start):
    import jax
    import jax.numpy as jnp
    shapes, _ = setup.model.abstract_init(setup.ctx)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(
            start[".".join(str(k.key) for k in path)], x.dtype), shapes)


def _jax_steps(jts, setup, start, inp, name, out):
    import jax
    import jax.numpy as jnp
    state = jts.init_state(setup, jax.random.key(0))

    def put(path, x):
        leaf = ".".join(str(k.key) for k in path)
        return jax.device_put(jnp.asarray(start[leaf], x.dtype), x.sharding)
    state["params"] = jax.tree_util.tree_map_with_path(put, state["params"])
    if setup.zero1:
        state = jts._fill_zero1_master(setup, state, jts._bucket_layout(setup))
    step = jts.make_step(setup)(_batch(inp, name, 0))
    for s in range(STEPS):
        state, m = step(state, _batch(inp, name, s), jnp.float32(LR))
        m = jax.device_get(m)
        for k in ("loss", "grad_norm", "moe_aux"):
            out[f"{k}/{s}"] = np.asarray(m[k])
    host = jax.device_get(state["params"])
    for path, x in jax.tree_util.tree_flatten_with_path(host)[0]:
        out["param/" + ".".join(str(k.key) for k in path)] = \
            np.asarray(x, np.float32)


def _device_grads(setup, params, batch, moe_slices: int = 0):
    """Per device (a leading dim over every device of the mesh) the
    gradients of the step's scaled loss, the local loss sum and the MoE
    loss.  ``moe_slices > 1``: the MoE layer runs once per slice of the
    sequence and the load-balancing loss is the slices' mean (the port's
    SP routing, at ``tp = 1``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.models import moe as jmoe
    from repro.parallel.compat import shard_map
    from repro.train import train_step as jts
    model, ctx = setup.model, setup.ctx
    dp, p_dp = setup.dp_axes, setup.p_dp
    every = tuple(setup.mesh.axis_names)
    plain = jmoe.moe_apply

    def sliced(params_m, x, ctx_m, cfg):
        outs = [plain(params_m, xs, ctx_m, cfg)
                for xs in jnp.split(x, moe_slices, axis=1)]
        return (jnp.concatenate([y for y, _ in outs], axis=1),
                sum(a for _, a in outs) / moe_slices)

    def fn(params, batch):
        def loss_fn(p):
            ls, nt, aux = model.loss(p, batch, ctx)
            ng = jax.lax.psum(nt, dp)
            return ls * (p_dp / ng.astype(jnp.float32)) + COEF * aux, \
                (ls, aux)
        g, (ls, aux) = jax.grad(loss_fn, has_aux=True)(params)
        return (jax.tree.map(lambda x: x[None], g), ls[None],
                jnp.asarray(aux, jnp.float32)[None])
    bspecs = jts.make_batch_specs(setup)(batch)
    gspecs = jax.tree.map(lambda _: P(every), setup.param_specs,
                          is_leaf=lambda s: isinstance(s, P))
    f = shard_map(fn, setup.mesh, in_specs=(setup.param_specs, bspecs),
                  out_specs=(gspecs, P(every), P(every)))
    if moe_slices > 1:
        jmoe.moe_apply = sliced
    try:
        g, ls, aux = jax.jit(f)(params, batch)
    finally:
        jmoe.moe_apply = plain
    g = jax.device_get(g)
    return ({".".join(str(k.key) for k in path): np.asarray(x, np.float32)
             for path, x in jax.tree_util.tree_flatten_with_path(g)[0]},
            np.asarray(ls), np.asarray(aux))


def _model_dims(setup):
    """leaf -> the dim of its spec that names ``model`` (-1: none)."""
    import jax
    from jax.sharding import PartitionSpec as P
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            setup.param_specs, is_leaf=lambda x: isinstance(x, P))[0]:
        dims = [i for i, e in enumerate(s) if e is not None and "model" in (
            e if isinstance(e, tuple) else (e,))]
        out[".".join(str(k.key) for k in path)] = dims[0] if dims else -1
    return out


def _run_jax_pairs(inp, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.models import layers as jl
    from repro.parallel.compat import shard_map
    out = {}
    every = ("data", "model")
    for i, (op, sp, _) in enumerate(PAIRS):
        ctx = jl.ShardCtx(tp=2, seq_parallel=sp)
        fn = {"copy": lambda x, c=ctx: jl.tp_copy(x, c),
              "reduce": lambda x, c=ctx: jl.tp_reduce(x, c),
              "shared": lambda x, c=ctx: jl.maybe_tp_shared(x, c)}[op]

        def run(x, ct, fn=fn):
            y, vjp = jax.vjp(fn, x[0])
            (g,) = vjp(ct[0])
            return y[None], g[None]
        f = shard_map(run, mesh, in_specs=(P(every), P(every)),
                      out_specs=(P(every), P(every)))
        y, g = jax.jit(f)(jnp.asarray(inp[f"px/{i}"]),
                          jnp.asarray(inp[f"pct/{i}"]))
        out[f"y/{i}"], out[f"g/{i}"] = np.asarray(y), np.asarray(g)
    logits = jnp.asarray(inp["xent/logits"])
    labels = jnp.asarray(inp["xent/labels"])
    loss, vjp = jax.vjp(lambda z: jl.vocab_parallel_xent(
        z, labels, jl.CPU_CTX, XENT[2]), logits)
    out["xent/loss"] = np.asarray(loss)
    out["xent/grad"] = np.asarray(vjp(jnp.asarray(inp["xent/ct"]))[0])
    return out


#: the JAX subprocesses, run side by side: (what each computes)
JAX_PARTS = ("steps", DENSE, MOE)


def _run_jax(d, part):
    import jax
    from jax.sharding import Mesh

    from repro.parallel.compat import make_mesh
    from repro.train import train_step as jts
    assert len(jax.devices()) == RANKS
    inp = np.load(os.path.join(d, "in.npz"))
    mesh1 = Mesh(np.array(jax.devices()[:2]).reshape(2, 1),
                 ("data", "model"))
    mesh2 = make_mesh((2, 2), ("data", "model"))
    if part == "steps":
        np.savez(os.path.join(d, "jax_pairs.npz"),
                 **_run_jax_pairs(inp, mesh2))
        # ---- tp = 1 on data 2: the steps
        runs = {"zero1": (DENSE, dict(zero1=True)),
                "repl": (DENSE, dict(zero1=False)),
                "moe-repl": (MOE, dict(zero1=False))}
        for run, (name, ov) in runs.items():
            setup = _jax_setup(jts, mesh1, name, **ov)
            out = {}
            _jax_steps(jts, setup, _start(inp, name), inp, name, out)
            np.savez(os.path.join(d, f"jax_{run}.npz"), **out)
        return
    for name in ((DENSE, QK) if part == DENSE else (MOE,)):
        _run_jax_grads(d, inp, jts, mesh1, mesh2, name)
    if part == DENSE:
        _run_jax_agg(d, inp, jts, mesh2)


def _run_jax_grads(d, inp, jts, mesh1, mesh2, name):
    """Each data rank's gradients at ``tp = 1`` (and, for the MoE family,
    with the MoE layer run per sequence slice); JAX's own per-device
    gradients and forward at ``tp = 2``, without and with SP."""
    setup = _jax_setup(jts, mesh1, name, zero1=False)
    params = _jax_params(setup, _start(inp, name))
    batch = _batch(inp, name, 0)
    out = {}
    for tag, slices in (("", 0), ("sliced/", 2)):
        if slices and name != MOE:
            continue
        g, ls, aux = _device_grads(setup, params, batch, slices)
        out.update({f"{tag}g/{k}": v for k, v in g.items()})
        out[f"{tag}loss_sum"], out[f"{tag}aux"] = ls, aux
    np.savez(os.path.join(d, f"jax_grads_{name}.npz"), **out)
    if name == QK:
        return
    for sp in (False, True):
        setup2 = _jax_setup(jts, mesh2, name, zero1=False, seq_parallel=sp)
        g, ls, aux = _device_grads(
            setup2, _jax_params(setup2, _start(inp, name)), batch)
        dims = _model_dims(setup2)
        np.savez(os.path.join(d, f"jax_tp2_{name}_{int(sp)}.npz"),
                 loss_sum=ls, aux=aux,
                 **{f"g/{k}": v for k, v in g.items()},
                 **{f"dim/{k}": np.asarray(v) for k, v in dims.items()})


def _run_jax_agg(d, inp, jts, mesh2):
    """PowerSGD over ``data`` on each model rank's shard buckets of the
    ``tp = 1`` gradients (``data 2 x model 2``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import aggregator as jagg
    from repro.core.compression import powersgd as jpsgd
    from repro.parallel.compat import shard_map
    setup2 = _jax_setup(jts, mesh2, DENSE, zero1=False,
                        compression="powersgd")
    layout = jts._bucket_layout(setup2)
    grads = np.load(os.path.join(d, f"jax_grads_{DENSE}.npz"))
    local = {}
    for leaf, dim in _model_dims(setup2).items():
        full = grads[f"g/{leaf}"]                  # (data, *global)
        per = []
        for r in range(RANKS):
            g = full[r // 2]
            if dim >= 0:
                n = g.shape[dim] // 2
                g = np.take(g, np.arange(r % 2 * n, (r % 2 + 1) * n),
                            axis=dim)
            per.append(g)
        local[leaf] = jnp.asarray(np.stack(per))
    agg = jagg.GradAggregator(setup2.agg_cfg)
    states = tuple(jpsgd.PowerSGDState(
        q=jnp.asarray(inp[f"q/{i}"]), err=jnp.zeros(n, jnp.float32))
        for i, n in enumerate(layout.sizes))
    every = ("data", "model")

    def run(tree):
        out, _ = agg.aggregate_bucketed(
            jax.tree.map(lambda x: x[0], tree), states, layout)
        return jax.tree.map(lambda x: x[None], out)
    specs = _nest({k: P(every) for k in local})
    f = shard_map(run, mesh2, in_specs=(specs,), out_specs=specs)
    out = jax.device_get(jax.jit(f)(_nest(local)))
    flat = {".".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(out)[0]}
    np.savez(os.path.join(d, "jax_agg.npz"),
             sizes=np.asarray(layout.sizes),
             **{f"agg/{k}": v for k, v in flat.items()})


# ------------------------------------------------------------ port side
def _port_pairs(inp, rank):
    import torch

    from repro_torch.models import layers as tl
    out = {}
    for i, (op, sp, _) in enumerate(PAIRS):
        ctx = tl.ShardCtx(tp=2, seq_parallel=sp)
        fn = {"copy": lambda x, c=ctx: tl.tp_copy(x, c),
              "reduce": lambda x, c=ctx: tl.tp_reduce(x, c),
              "shared": lambda x, c=ctx: tl.maybe_tp_shared(x, c)}[op]
        x = torch.from_numpy(inp[f"px/{i}"][rank].copy()).requires_grad_()
        y = fn(x)
        (g,) = torch.autograd.grad(y, x, torch.from_numpy(
            inp[f"pct/{i}"][rank].copy()))
        out[f"y/{i}"], out[f"g/{i}"] = y.detach().numpy(), g.numpy()
    logits = inp["xent/logits"]
    v = XENT[2] // 2
    m = rank % 2
    local = torch.from_numpy(
        logits[..., m * v:(m + 1) * v].copy()).requires_grad_()
    loss = tl.vocab_parallel_xent(local, torch.from_numpy(
        inp["xent/labels"]), tl.ShardCtx(tp=2))
    (g,) = torch.autograd.grad(loss, local, torch.from_numpy(
        inp["xent/ct"].copy()))
    out["xent/loss"], out["xent/grad"] = loss.detach().numpy(), g.numpy()
    return out


def _state_prints(state):
    from repro_torch.train.pod_worker import fingerprint, _state_tensors
    return [fingerprint(t) for t in _state_tensors(state)]


def _port_setup(tts, convert, name, ov, start):
    import torch

    from repro_torch.configs import base as tcfgs
    plan = {"dp_mode": "ddp", "bucket_mb": BUCKET_MB, **ov}
    setup = tts.build(_reduced(tcfgs, name), "cpu", **plan)
    setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                          compute_dtype=torch.float32)
    state = tts.init_state(setup)
    convert.load_params(setup.model, _nest(start))
    if setup.zero1:
        state = tts._fill_zero1_master(setup, state)
    return setup, state


def _port_case(inp, rank, case):
    """Every rank runs the case; returns this rank's record."""
    import torch

    from repro_torch import convert
    from repro_torch.core import aggregator as tagg
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import overlap
    from repro_torch.train import train_step as tts
    from repro_torch.train.pod_worker import fingerprint
    name, tp, ov, oracle = CASES[case]
    if mesh_mod.tp_size() != tp:
        mesh_mod.init_mesh(tp, torch.device("cpu"))
    dp = mesh_mod.present_axes()
    p_dp, dp_rank = mesh_mod.size(dp), mesh_mod.rank(dp)
    start = _start(inp, name)
    setup, state = _port_setup(tts, convert, name, ov, start)
    if oracle == "agg":
        state["agg"] = convert.agg_states(
            setup.agg_cfg.build(),
            [{"q": inp[f"q/{i}"], "err": np.zeros(n, np.float32)}
             for i, n in enumerate(setup.layout.sizes)], index=None)
    agg0 = state["agg"]
    out = {"tp": setup.tp, "sp": setup.model.ctx.seq_parallel,
           "coords": [mesh_mod.coords()[a] for a in ("data", "model")],
           "sizes": np.asarray(setup.layout.sizes)}
    b0 = tts._to_device(tts.split_batch(_batch(inp, name, 0), p_dp,
                                        dp_rank), setup.device)
    names = [n for n, _ in setup.model.named_parameters()]
    if _records_grads(ov):
        # step 0's gradients before any aggregation, and their aggregate
        grads, loss_sum, _, aux = tts.local_grads(setup, b0)
        out["loss_sum"], out["aux"] = loss_sum.item(), aux.item()
        for n, g in zip(names, grads):
            out[f"g/{n}"] = convert.to_global(setup.model, n, g).numpy()
        if oracle == "agg":
            agg, _ = tagg.GradAggregator(setup.agg_cfg).aggregate_bucketed(
                [g.clone() for g in grads], agg0, setup.layout)
            for n, g in zip(names, agg):
                out[f"agg/{n}"] = g.numpy()
        del grads
    step = tts.make_step(setup)
    for s in range(STEPS):
        b = tts.split_batch(_batch(inp, name, s), p_dp, dp_rank)
        state, m = step(state, b, LR)
        for k in ("loss", "grad_norm", "moe_aux"):
            out[f"{k}/{s}"] = m[k].item()
    for n, p in convert.global_params(setup.model).items():
        out[f"param/{n}"] = p.float().numpy()
    out["prints"] = np.asarray([fingerprint(p)
                                for p in setup.model.parameters()])
    out["replicated"] = np.asarray(setup.model_replicated())
    if setup.overlap:
        prints = _state_prints(state)
        setup2, state2 = _port_setup(tts, convert, name, ov, start)
        state2["agg"] = agg0
        sstep = overlap.make_step(setup2, "serial")
        for s in range(STEPS):
            b = tts.split_batch(_batch(inp, name, s), p_dp, dp_rank)
            state2, m = sstep(state2, b, LR)
            assert m["loss"].item() == out[f"loss/{s}"]
        out["serial_equals_overlap"] = _state_prints(state2) == prints
    # the global arrays: once per data rank (gradients), once (parameters)
    if out["coords"][1]:
        out = {k: v for k, v in out.items()
               if not k.startswith(("param/", "g/"))}
    elif dp_rank:
        out = {k: v for k, v in out.items() if not k.startswith("param/")}
    return out


def _port_adafactor(inp):
    """The Adafactor update on each rank's TP shards (two steps, random
    gradients of the global leaves) against the unsharded update of the
    same global gradients, on the gathered arrays: the largest relative
    difference (the factored means and the RMS clip sum over ``model``
    for the leaves it shards)."""
    import torch

    from repro_torch import convert
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as tts
    start = _start(inp, DENSE)
    setup, _ = _port_setup(tts, convert, DENSE,
                           dict(zero1=False, optimizer="adafactor"), start)
    model = setup.model
    names = [n for n, _ in model.named_parameters()]
    gen = torch.Generator().manual_seed(3)
    grads = [{n: torch.randn(start[n].shape, generator=gen) for n in names}
             for _ in range(STEPS)]
    cfg = opt_mod.OptConfig(name="adafactor")
    sharded = opt_mod.make("adafactor", cfg, setup.sharding)
    plain = opt_mod.make("adafactor", cfg)
    p_loc = list(model.parameters())
    p_full = [torch.from_numpy(start[n].copy()) for n in names]
    s_loc, s_full = sharded.init(p_loc), plain.init(p_full)
    for g in grads:
        g_loc = [model.shard_slice(n, g[n]).contiguous() for n in names]
        _, s_loc, m_loc = sharded.update(g_loc, s_loc, p_loc, LR)
        _, s_full, m_full = plain.update([g[n] for n in names], s_full,
                                         p_full, LR)
    worst = abs(m_loc["grad_norm"].item() / m_full["grad_norm"].item() - 1)
    for n, p, q in zip(names, p_loc, p_full):
        got = convert.to_global(model, n, p)
        worst = max(worst, ((got - q).abs().max()
                            / q.abs().max().clamp(min=1e-30)).item())
    return worst


def _run_torch(d, rank, port):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        mesh_mod.init_mesh(2, torch.device("cpu"))
        inp = np.load(os.path.join(d, "in.npz"))
        np.savez(os.path.join(d, f"torch_pairs_{rank}.npz"),
                 **_port_pairs(inp, rank))
        np.savez(os.path.join(d, f"torch_adafactor_{rank}.npz"),
                 worst=_port_adafactor(inp))
        for case in CASES:
            np.savez(os.path.join(d, f"torch_{case}_{rank}.npz"),
                     **_port_case(inp, rank, case))
    finally:
        dist.destroy_process_group()


def _env(**extra):
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Runs every case on both sides; returns the directory."""
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("tp"))
    _make_inputs(d)
    me = os.path.abspath(__file__)
    xla = os.environ.get("XLA_FLAGS", "") \
        + f" --xla_force_host_platform_device_count={RANKS}"
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, me, "jax", d, part],
                              env=_env(XLA_FLAGS=xla),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for part in JAX_PARTS]
    procs += [subprocess.Popen([sys.executable, me, "torch", d, str(r),
                                port], env=_env(OMP_NUM_THREADS="1"),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(RANKS)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, f"{p.args[2:]} failed:\n{text[-3000:]}"
    return d


def _load(d, name):
    return np.load(os.path.join(d, f"{name}.npz"))


def _ports(d, case):
    return [_load(d, f"torch_{case}_{r}") for r in range(RANKS)]


def _records_grads(ov):
    """Do the case's ranks record step-0 gradients?  (replicated DDP
    parameters only)"""
    return not ov.get("zero1") and ov.get("dp_mode", "ddp") == "ddp"


def _assert_close_to_lr(got, want, what, share=True):
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * STEPS + 1e-4, (what, diff.max())
    if share:
        assert (diff > LR / 2).mean() <= 0.02, (what,
                                                 (diff > LR / 2).mean())
    assert np.median(diff) <= LR / 50, (what, np.median(diff))


def _assert_grads(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max() + 1e-9,
                               err_msg=what)


def _assert_params(pt, jx, start, what):
    small = []
    for k in sorted(k for k in jx.files if k.startswith("param/")):
        leaf = k.split("/", 1)[1]
        assert pt[k].shape == jx[k].shape == start[leaf].shape, k
        _assert_close_to_lr(pt[k], jx[k], f"{what} {k}",
                            share=jx[k].size >= SMALL_LEAF)
        if jx[k].size < SMALL_LEAF:
            small.append((pt[k].ravel(), jx[k].ravel()))
    _assert_close_to_lr(*(np.concatenate(x) for x in zip(*small)),
                        f"{what} small leaves")


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if v[3] in ("zero1", "repl", "moe-repl")])
def test_tp_step_matches_jax_tp1(results, case):
    """Loss, grad norm and the parameters after the steps against JAX's
    step at ``tp = 1`` on the same global weights and batches."""
    name, tp, ov, oracle = CASES[case]
    jx = _load(results, f"jax_{oracle}")
    ports = _ports(results, case)
    rtol = 1e-3 if ov.get("zero1") else 1e-5
    for pt in ports:
        assert int(pt["tp"]) == tp
        assert bool(pt["sp"]) == ov.get("seq_parallel", True)
        for s in range(STEPS):
            np.testing.assert_allclose(pt[f"loss/{s}"], jx[f"loss/{s}"],
                                       rtol=rtol, err_msg=f"{case} loss")
            np.testing.assert_allclose(pt[f"grad_norm/{s}"],
                                       jx[f"grad_norm/{s}"], rtol=rtol,
                                       err_msg=f"{case} grad norm")
            if int(pt["coords"][0]) == 0:  # JAX reports device 0's
                np.testing.assert_allclose(pt[f"moe_aux/{s}"],
                                           jx[f"moe_aux/{s}"], rtol=1e-4,
                                           atol=1e-7,
                                           err_msg=f"{case} aux {s}")
    start = _start(np.load(os.path.join(results, "in.npz")), name)
    _assert_params(ports[0], jx, start, case)


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if _records_grads(v[2])])
def test_tp_gradients_match_the_oracle(results, case):
    """Each leaf's step-0 gradient, per data rank, gathered over
    ``model``: JAX's ``tp = 1`` gradient of the same data rank's rows (at
    ``model 4`` the one data rank holds every row: the mean of JAX's
    two); the MoE step under SP: JAX's ``tp = 1`` step with the MoE layer
    run once per sequence slice."""
    name, tp, ov, oracle = CASES[case]
    jx = _load(results, f"jax_grads_{name}")
    pre = "sliced/" if oracle == "moe-sp" else ""
    ports = _ports(results, case)
    n_leaves = 0
    for pt in ports:
        if "g/embed.table" not in pt.files:
            continue                      # a model rank > 0
        d = int(pt["coords"][0])
        for k in (k for k in pt.files if k.startswith("g/")):
            want = jx[pre + k]
            want = want[d] if tp == 2 else want.mean(0)
            _assert_grads(pt[k], want, f"{case} {k} data {d}")
            n_leaves += 1
    assert n_leaves == len([k for k in jx.files if k.startswith("g/")]) \
        * (RANKS // tp)


@pytest.mark.parametrize("case", ["h-moe-nosp", "i-moe-sp"])
def test_moe_forward_matches_jax_tp2(results, case):
    """The loss sum and ``moe_aux`` of each rank against JAX's ``tp = 2``
    forward on the same device of ``data 2 x model 2``: without SP every
    model rank's equal to ``tp = 1``; with SP each rank's load-balancing
    loss is that of its own tokens, as in JAX."""
    sp = int(CASES[case][2].get("seq_parallel", True))
    jx = _load(results, f"jax_tp2_{MOE}_{sp}")
    auxes = []
    for r, pt in enumerate(_ports(results, case)):
        np.testing.assert_allclose(pt["loss_sum"], jx["loss_sum"][r],
                                   rtol=1e-5, err_msg=f"{case} rank {r}")
        np.testing.assert_allclose(pt["aux"], jx["aux"][r], rtol=1e-5,
                                   err_msg=f"{case} rank {r}")
        auxes.append(float(pt["aux"]))
    # SP: the two model ranks of a data rank route different tokens
    assert (auxes[0] != auxes[1]) == bool(sp)


def test_powersgd_over_shard_buckets_matches_jax(results):
    """Step 0's PowerSGD aggregate over ``data`` of each model rank's
    shard buckets against JAX's aggregator on the same buckets of the
    ``tp = 1`` gradients; the bucket layouts are the same."""
    jx = _load(results, "jax_agg")
    case = "e-sp-replicated-powersgd"
    for r, pt in enumerate(_ports(results, case)):
        assert list(pt["sizes"]) == list(jx["sizes"])
        keys = [k for k in pt.files if k.startswith("agg/")]
        assert keys
        for k in keys:
            want = jx[k][r]
            np.testing.assert_allclose(pt[k], want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("case", list(CASES))
def test_replicas_hold_the_same_bits(results, case):
    """After the steps the ranks with the same model index hold the same
    bits (the DP replicas; under FSDP the ranks hold their own shards and
    the FSDP test checks the gathers), every leaf replicated over
    ``model`` holds the same bits on every rank, and the losses are the
    same everywhere."""
    ports = _ports(results, case)
    tp = CASES[case][1]
    fsdp = CASES[case][2].get("dp_mode") == "fsdp"
    for pt in ports:
        for s in range(STEPS):
            assert pt[f"loss/{s}"] == ports[0][f"loss/{s}"]
    rep = ports[0]["replicated"]
    assert rep.any()
    for pt in ports:
        m = int(pt["coords"][1])
        if not fsdp:
            np.testing.assert_array_equal(pt["prints"], ports[m]["prints"])
        np.testing.assert_array_equal(pt["prints"][rep],
                                      ports[0]["prints"][rep])
    if tp == 2 and not fsdp:      # the model ranks hold different shards
        assert not np.array_equal(ports[0]["prints"][~rep],
                                  ports[1]["prints"][~rep])


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if v[2].get("overlap")])
def test_serial_equals_overlap(results, case):
    for pt in _ports(results, case):
        assert bool(pt["serial_equals_overlap"])


def test_fg_pairs_and_vocab_parallel_xent(results):
    """``tp_copy``, ``tp_reduce`` and ``tp_shared`` equal JAX's custom
    VJPs on every device, forward and backward; the vocabulary-parallel
    cross-entropy gives every rank the loss of the whole logits and the
    gradient of its vocabulary slice of that loss, once (JAX's ``tp = 1``
    function)."""
    jx = _load(results, "jax_pairs")
    v = XENT[2] // 2
    for r in range(RANKS):
        pt = _load(results, f"torch_pairs_{r}")
        for i, pair in enumerate(PAIRS):
            np.testing.assert_array_equal(pt[f"y/{i}"], jx[f"y/{i}"][r],
                                          err_msg=f"{pair} y rank {r}")
            np.testing.assert_array_equal(pt[f"g/{i}"], jx[f"g/{i}"][r],
                                          err_msg=f"{pair} g rank {r}")
        np.testing.assert_allclose(pt["xent/loss"], jx["xent/loss"],
                                   rtol=1e-6)
        m = r % 2
        np.testing.assert_allclose(
            pt["xent/grad"], jx["xent/grad"][..., m * v:(m + 1) * v],
            rtol=1e-6, atol=1e-7)


def test_sharded_adafactor_equals_the_unsharded_update(results):
    """Adafactor on the TP shards of ``data 2 x model 2`` (the factored
    row and column means, the RMS clip and the global norm summed over
    ``model`` where it shards a leaf) against the unsharded update of
    the same global gradients: 1e-6 relative."""
    for r in range(RANKS):
        assert float(_load(results, f"torch_adafactor_{r}")["worst"]) \
            <= 1e-6


def _ratio(got, want):
    """(least-squares factor of ``got`` over ``want``, relative
    residual)."""
    a = float((got * want).sum() / max((want * want).sum(), 1e-30))
    res = float(np.linalg.norm(got - a * want)
                / max(np.linalg.norm(got), 1e-30))
    return a, res


def _jax_tp2_global(jx, leaf):
    """JAX's ``tp = 2`` gradient of data rank 0 as its step sees it: the
    model shards concatenated along the leaf's ``model`` dim, model rank
    0's copy of a replicated leaf."""
    g, dim = jx[f"g/{leaf}"], int(jx[f"dim/{leaf}"])
    if dim < 0:
        return g[0]
    return np.concatenate([g[0], g[1]], axis=dim)


@pytest.mark.parametrize("name, sp", [(DENSE, 0), (DENSE, 1), (MOE, 0)])
def test_reference_tp_gradient_factors(results, name, sp):
    """Pins the JAX package's gradients at ``tp = 2`` against its own at
    ``tp = 1`` (a limit of the comparison, ROADMAP §3): each model rank
    differentiates its own copy of the loss and every raw ``psum``
    transposes into a second sum over ``model``.  Dense without SP: every
    leaf twice its ``tp = 1`` gradient, the embedding table four times.
    With SP: the matrices and the embedding (whose ``psum_scatter`` is
    the SP entry) twice, the block and final
    norms not proportional (each rank keeps its own tokens' part).  MoE
    without SP: the attention, the shared experts, the norms and the
    unembedding twice; the experts, the router, the shared gate and the
    embedding four times (``tp * ep``).  The port's gradients are the
    loss's, once (``test_tp_gradients_match_the_oracle``)."""
    jx = _load(results, f"jax_tp2_{name}_{sp}")
    ref = _load(results, f"jax_grads_{name}")
    four = set() if sp else {"embed.table"}
    if name == MOE:
        four |= {"blocks.moe.experts.down", "blocks.moe.experts.gate",
                 "blocks.moe.experts.up", "blocks.moe.router",
                 "blocks.moe.shared_gate"}
    norms = {"blocks.ln1.scale", "blocks.ln2.scale", "final_norm.scale"}
    for k in (k for k in jx.files if k.startswith("g/")):
        leaf = k[2:]
        a, res = _ratio(_jax_tp2_global(jx, leaf), ref[k][0])
        if sp and leaf in norms:
            assert res > 0.1, (leaf, a, res)
            continue
        want = 4.0 if leaf in four else 2.0
        assert abs(a - want) < 0.02 * want and res < 0.02, (leaf, a, res)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2], sys.argv[3])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), sys.argv[4])
