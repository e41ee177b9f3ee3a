"""The ``model`` axis of the port (tensor and sequence parallelism) for
the hybrid (zamba2) and ssm (xLSTM) families against the JAX package.

* Four ranks: the JAX package on 4 fake CPU devices in five
  subprocesses (``JAX_PARTS``: one or two per arch key), the port on 4 gloo
  processes, all started together, each with ``OMP_NUM_THREADS=1``.  The
  port runs every case of ``CASES`` on ``data 2 x model 2``
  (``launch.mesh.init_mesh``) or on ``model 4``, ``STEPS`` steps at lr
  1e-3 from the same global parameters (drawn here with numpy, bf16
  values held in fp32, loaded with ``convert.load_params``) and the same
  global batches, computing in fp32, on the reduced ``zamba2-2.7b`` (2
  groups of 2 Mamba2 blocks, 16 SSD heads, 4 attention heads), the
  reduced ``xlstm-350m`` (2 groups of 1 mLSTM and 1 sLSTM block, 4 heads)
  and the same with 2 heads, so that ``model 4`` splits each mLSTM
  head's values over ``r = 2`` ranks.  ``lora.*.b``, whose init is zero,
  is drawn small and not zero, so that ``lora.*.a`` has a gradient at
  step 0 too; two steps.
* The oracle is the JAX package's step at ``tp = 1`` on ``data 2`` with
  the same global weights and batches (its gradients at ``tp > 1`` are
  not its loss's: ``test_reference_tp_gradient_factors`` in
  ``test_torch_tp_step.py``): the loss, the grad norm, each leaf's step-0
  gradient (before any aggregation, per data rank) and the parameters
  after the steps.  The ``accum = 2`` case is held to JAX's ``tp = 1``
  step at ``accum = 2``, the ZeRO-1 cases to JAX's ``tp = 1`` ZeRO-1
  step.  The ZeRO-1 PowerSGD case holds its first loss to the oracle's
  and its aggregated step-0 gradient to JAX's
  ``GradAggregator.aggregate_bucketed`` over ``data`` on ``data 2 x
  model 2``, over the same bf16 shard buckets of JAX's ``tp = 1``
  gradients (JAX's warm starts injected).
* The ``r > 1`` layout is another function than ``tp = 1``: the mLSTM
  grouped norm spans the ``dv / r`` values a rank holds.  Its first loss
  is held to JAX's forward at ``tp = 4``, which is right (only JAX's
  transposed sums are not).  Its gradients are held to JAX's ``tp = 1``
  step of the same function: the JAX subprocess runs it with the mLSTM's
  grouped norm over ``dv / r`` values (``repro.models.mamba2.
  _grouped_rmsnorm`` wrapped in that process only), whose forward loss
  equals the ``tp = 4`` one.  (A central difference of the ``tp = 4``
  loss is no oracle here: the stabiliser maxima and the normaliser's
  floor make the loss piecewise smooth, and on JAX's own ``tp = 1``
  function central differences at 1% of a leaf's norm miss its exact
  gradient by 10-46% on some leaves.)
* Every case: the ranks with the same model index hold the same bits
  after the steps, and so do the leaves replicated over ``model`` on
  every rank; the overlapped cases' serial schedule gives the same bits.
* In process: ``Model.tp_dims`` and the global shapes against the JAX
  package's ``abstract_init`` specs, leaf by leaf.

Tolerances are ``test_torch_tp_step.py``'s and
``test_torch_tp_families.py``'s: loss and grad norm ``rtol=1e-5`` (bf16
parameters under ZeRO-1: 1e-3); per-leaf gradients within ``1e-4`` of
the leaf's largest entry; parameters by the FSDP rule (max difference at
most ``2 * lr * steps + 1e-4``, at most 2% of elements beyond ``lr / 2``,
median at most ``lr / 50``); the ZeRO-1 aggregate within ``BF16_AGG`` of
the bucket's largest entry; replicas bit for bit.  The grad norm after
step 0 is held to ``GNORM_STEP_RTOL`` (2e-4): the JAX package against
itself, its XLA optimisation level or threading changed, moves it by
up to 6.5e-5 on these cases.  Under ZeRO-1 the grad norm follows
``test_torch_ssm_step.py``'s rule for these chaotic models:
``rtol=1e-2`` at step 0, ``GNORM_DRIFT`` (5e-2) after it.  The JAX
processes compile at XLA's LLVM optimisation level 0, which saves ~40%
of their CPU time.

The draw is ``SEED`` 44.  On seeds 41-45 the port's ``tp = 1`` step-0
gradients sit 5e-6 to 6e-5 of each leaf's largest entry from JAX's,
save seed 41's second data rank of the xLSTM, at 2.6e-4: one token's
gradient there is ~35 times the others' (the mLSTM backward amplifies
it), and the rounding of the two packages' fp32 sums, each block's VJP
equal to 1e-6, moves it that far.  That is no question of the
``model`` axis, which this file tests.

This file is also the subprocess script: ``python
test_torch_tp_recurrent.py jax DIR PART`` or ``python
test_torch_tp_recurrent.py torch DIR RANK PORT``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import test_torch_tp_step as tp_step
from test_torch_tp_families import BF16_AGG, _records_grads
from test_torch_tp_step import (GLOBAL_BATCH, LR, RANKS, SEQ, STEPS,
                                _assert_grads, _assert_params, _batch, _env,
                                _jax_params, _load, _model_dims, _nest,
                                _start, _state_prints)

HYBRID, SSM = "zamba2-2.7b", "xlstm-350m"
#: arch key -> (registered arch, heads in place of the reduced config's)
ARCHS = {"hybrid": (HYBRID, None), "ssm": (SSM, None), "ssm-r2": (SSM, 2)}
BUCKET_MB = 0.0625
TIMEOUT_S = 300
SEED = 44
#: the ZeRO-1 grad norm's limit after step 0 (``test_torch_ssm_step.py``)
GNORM_DRIFT = 5e-2
#: the fp32 grad norm's limit after step 0: JAX against itself, with
#: XLA's LLVM optimisation level or its Eigen threading changed, moves it
#: by 1.1e-5 to 6.5e-5 on these cases (Adam's first step, ``lr * g /
#: |g|``, turns rounding into sign flips of the smallest gradients)
GNORM_STEP_RTOL = 2e-4
#: the LoRA ``b`` drawn with this std in place of its zero init, so that
#: ``lora.*.a`` has a gradient at step 0 too
LORA_B_STD = 0.02

#: case -> (arch key, tp, plan overrides beside bucket_mb, accum, the JAX
#: oracle run); every case but the FSDP one runs dp_mode="ddp"
CASES = {
    "a-hybrid-sp": ("hybrid", 2, dict(zero1=False), 1, "hybrid"),
    "b-hybrid-nosp": ("hybrid", 2, dict(zero1=False, seq_parallel=False),
                      1, "hybrid"),
    "c-hybrid-sp-zero1-overlap": ("hybrid", 2, dict(zero1=True,
                                                    overlap=True), 1,
                                  "hybrid-zero1"),
    "d-hybrid-sp-accum2": ("hybrid", 2, dict(zero1=False), 2,
                           "hybrid-accum2"),
    "e-hybrid-fsdp-sp": ("hybrid", 2, dict(dp_mode="fsdp", zero1=False), 1,
                         "hybrid"),
    "f-ssm-sp": ("ssm", 2, dict(zero1=False), 1, "ssm"),
    "g-ssm-nosp": ("ssm", 2, dict(zero1=False, seq_parallel=False), 1,
                   "ssm"),
    "h-ssm-sp-zero1-overlap": ("ssm", 2, dict(zero1=True, overlap=True), 1,
                               "ssm-zero1"),
    "i-ssm-model4": ("ssm", 4, dict(zero1=False), 1, "ssm"),
    "j-ssm-sp-zero1-powersgd": ("ssm", 2, dict(
        zero1=True, compression="powersgd"), 1, "agg"),
    "k-ssm-r2-model4": ("ssm-r2", 4, dict(zero1=False), 1, "ssm-r2"),
}
#: the JAX subprocesses, run side by side: part -> (arch key, its oracle
#: runs, and does it also take the step-0 gradients and their aggregate);
#: two per arch that has more than one oracle run, so that no process
#: compiles more than two steps
JAX_PARTS = {
    "hybrid": ("hybrid", ("hybrid",), True),
    "hybrid-more": ("hybrid", ("hybrid-accum2", "hybrid-zero1"), False),
    "ssm": ("ssm", ("ssm",), True),
    "ssm-more": ("ssm", ("ssm-zero1",), False),
    "ssm-r2": ("ssm-r2", ("ssm-r2",), True),
}


def _arch(cfgs, key):
    name, heads = ARCHS[key]
    cfg = cfgs.reduced(cfgs.get(name))
    return dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads) \
        if heads else cfg


def _case_of(oracle):
    return next(c for c, v in CASES.items() if v[4] == oracle)


def _port_layout_sizes():
    """Bucket sizes of the port's ZeRO-1 layout of the agg case over the
    local shards of a rank of ``data 2 x model 2`` (bf16 parameters; no
    allocation)."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.core import bucketing
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    model = Model(_arch(tcfgs, CASES[_case_of("agg")][0]), ShardCtx(
        param_dtype=torch.bfloat16, tp=2, seq_parallel=True), device="meta")
    return bucketing.layout_for(list(model.parameters()), BUCKET_MB).sizes


# ------------------------------------------------------------ the inputs
def _make_inputs(d):
    """in.npz: per arch key the start parameters (global, bf16 values
    held in fp32) and the global batches; the PowerSGD warm starts JAX's
    ``init_state`` draws for the agg case's shard buckets."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    from repro.core.compression import base as jbase
    from repro.data.synthetic import DataConfig, batch_at
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_layout
    import torch

    from repro_torch.models.model import init_leaf_
    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(SEED)
    arrays = {}
    for key in ARCHS:
        cfg = _arch(tcfgs, key)
        for leaf, shape, init in param_layout(cfg):
            if init is None:
                value = np.ones(shape)
            elif init == "zeros":            # the LoRA b: not zero, so
                value = LORA_B_STD * rng.standard_normal(shape)  # a moves
            elif isinstance(init, str):      # A_log, dt_bias, b_if, b_gates
                value = torch.empty(shape)
                init_leaf_(value, init, gen)
                value = value.numpy()
            else:
                value = init * np.clip(rng.standard_normal(shape), -3, 3)
            arrays[f"param/{key}/{leaf}"] = np.asarray(
                jnp.asarray(value, jnp.bfloat16), np.float32)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                          global_batch=GLOBAL_BATCH)
        for s in range(STEPS):
            b = batch_at(dcfg, s)
            for k in ("tokens", "labels"):
                arrays[f"batch/{key}/{s}/{k}"] = b[k]
    plan = dataclasses.replace(_arch(jcfgs, "ssm").plan,
                               **CASES[_case_of("agg")][2])
    comp = jbase.make(plan.compression, **jbase.plan_kwargs(plan))
    sizes = _port_layout_sizes()
    keys = jax.random.split(jax.random.fold_in(jax.random.key(0), 7),
                            len(sizes))
    for i, (n, k) in enumerate(zip(sizes, keys)):
        arrays[f"q/{i}"] = np.asarray(comp.init_state(n, k).q)
    np.savez(os.path.join(d, "in.npz"), **arrays)


# ------------------------------------------------------------- JAX side
def _jax_setup(jts, mesh, key, **ov):
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    setup = jts.build(_arch(jcfgs, key), mesh, bucket_mb=BUCKET_MB,
                      **{"dp_mode": "ddp", **ov})
    setup.ctx = dataclasses.replace(setup.ctx, compute_dtype=jnp.float32)
    return setup


def _jax_steps(jts, setup, start, inp, key, accum):
    """The oracle run: ``STEPS`` steps from ``start`` (the ZeRO-1 master
    filled from it); its losses, grad norms and final parameters."""
    import jax
    import jax.numpy as jnp
    state = jts.init_state(setup, jax.random.key(0))

    def put(path, x):
        leaf = ".".join(str(k.key) for k in path)
        return jax.device_put(jnp.asarray(start[leaf], x.dtype), x.sharding)
    state["params"] = jax.tree_util.tree_map_with_path(put, state["params"])
    if setup.zero1:
        state = jts._fill_zero1_master(setup, state, jts._bucket_layout(setup))
    step = jts.make_step(setup, accum=accum)(_batch(inp, key, 0))
    out = {}
    for s in range(STEPS):
        state, m = step(state, _batch(inp, key, s), jnp.float32(LR))
        m = jax.device_get(m)
        for k in ("loss", "grad_norm"):
            out[f"{k}/{s}"] = np.asarray(m[k])
    host = jax.device_get(state["params"])
    for path, x in jax.tree_util.tree_flatten_with_path(host)[0]:
        out["param/" + ".".join(str(k.key) for k in path)] = \
            np.asarray(x, np.float32)
    return out


def _run_jax_agg(d, jts, mesh2, grads, inp):
    """PowerSGD over ``data`` on each model rank's ZeRO-1 shard buckets
    (bf16) of the ``tp = 1`` gradients (``data 2 x model 2``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import aggregator as jagg
    from repro.core.compression import powersgd as jpsgd
    from repro.parallel.compat import shard_map
    case = _case_of("agg")
    setup2 = _jax_setup(jts, mesh2, CASES[case][0], **CASES[case][2])
    layout = jts._bucket_layout(setup2)
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
        local[leaf] = jnp.asarray(np.stack(per), jnp.bfloat16)
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
    flat = {".".join(str(k.key) for k in path): np.asarray(x, np.float32)
            for path, x in jax.tree_util.tree_flatten_with_path(out)[0]}
    np.savez(os.path.join(d, "jax_agg.npz"),
             sizes=np.asarray(layout.sizes),
             **{f"agg/{k}": v for k, v in flat.items()})


def _run_jax_r2_forward(d, jts, inp):
    """The ``r > 1`` arch's loss at ``tp = 4`` (``data 1 x model 4``):
    one forward pass of step 0's batch, on every device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.parallel.compat import make_mesh, shard_map
    key = "ssm-r2"
    setup = _jax_setup(jts, make_mesh((1, 4), ("data", "model")), key,
                       zero1=False)
    batch = _batch(inp, key, 0)

    def fn(params, b):
        ls, nt, _ = setup.model.loss(params, b, setup.ctx)
        return (ls / jax.lax.psum(nt, setup.dp_axes).astype(
            jnp.float32))[None]
    f = jax.jit(shard_map(fn, setup.mesh, in_specs=(
        setup.param_specs, jts.make_batch_specs(setup)(batch)),
        out_specs=P(("data", "model"))))
    loss = f(_jax_params(setup, _start(inp, key)), batch)
    np.savez(os.path.join(d, "jax_r2_forward.npz"), loss=np.asarray(loss))


def _norm_over_value_parts(r: int) -> None:
    """In this process only: the JAX package's mLSTM grouped norm over
    ``dv / r`` values, the ``r > 1`` function at ``tp = 1``."""
    from repro.models import mamba2 as jm2
    plain = jm2._grouped_rmsnorm

    def grouped(scale, y, z, head_dim, eps):
        return plain(scale, y, z, head_dim // r, eps)
    jm2._grouped_rmsnorm = grouped


def _run_jax(d, part):
    """One part of ``JAX_PARTS``: its oracle runs (``tp = 1`` on ``data
    2``), and in the first part of an arch its per-data-rank gradients
    of step 0, and for the ssm arch the PowerSGD aggregate over the
    ZeRO-1 shard buckets; for the ``r > 1`` arch its ``tp = 4`` forward
    first, then its ``tp = 1`` runs with the grouped norm over the value
    parts."""
    import jax
    from jax.sharding import Mesh

    from repro.parallel.compat import make_mesh
    from repro.train import train_step as jts
    assert len(jax.devices()) == RANKS
    key, runs, grads_too = JAX_PARTS[part]
    inp = np.load(os.path.join(d, "in.npz"))
    if key == "ssm-r2":
        _run_jax_r2_forward(d, jts, inp)
        _norm_over_value_parts(4 // ARCHS[key][1])
    mesh1 = Mesh(np.array(jax.devices()[:2]).reshape(2, 1),
                 ("data", "model"))
    start = _start(inp, key)
    for run in runs:
        setup = _jax_setup(jts, mesh1, key,
                           zero1=run.endswith("zero1"))
        accum = 2 if run.endswith("accum2") else 1
        np.savez(os.path.join(d, f"jax_{run}.npz"),
                 **_jax_steps(jts, setup, start, inp, key, accum))
    if not grads_too:
        return
    setup = _jax_setup(jts, mesh1, key, zero1=False)
    g, ls, _ = tp_step._device_grads(setup, _jax_params(setup, start),
                                     _batch(inp, key, 0))
    grads = {f"g/{k}": v for k, v in g.items()}
    np.savez(os.path.join(d, f"jax_grads_{key}.npz"), loss_sum=ls, **grads)
    if CASES[_case_of("agg")][0] == key:
        _run_jax_agg(d, jts, make_mesh((2, 2), ("data", "model")), grads,
                     inp)


# ------------------------------------------------------------ port side
def _port_setup(tts, convert, key, ov, start):
    import torch

    from repro_torch.configs import base as tcfgs
    plan = {"dp_mode": "ddp", "bucket_mb": BUCKET_MB, **ov}
    setup = tts.build(_arch(tcfgs, key), "cpu", **plan)
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
    key, tp, ov, accum, oracle = CASES[case]
    if mesh_mod.tp_size() != tp:
        mesh_mod.init_mesh(tp, torch.device("cpu"))
    dp = mesh_mod.present_axes()
    p_dp, dp_rank = mesh_mod.size(dp), mesh_mod.rank(dp)
    start = _start(inp, key)
    setup, state = _port_setup(tts, convert, key, ov, start)
    if oracle == "agg":
        state["agg"] = convert.agg_states(
            setup.agg_cfg.build(),
            [{"q": inp[f"q/{i}"], "err": np.zeros(n, np.float32)}
             for i, n in enumerate(setup.layout.sizes)], index=None)
    agg0 = state["agg"]
    out = {"tp": setup.tp, "sp": setup.model.ctx.seq_parallel,
           "coords": [mesh_mod.coords()[a] for a in ("data", "model")],
           "sizes": np.asarray(setup.layout.sizes)}
    b0 = tts._to_device(tts.split_batch(_batch(inp, key, 0), p_dp,
                                        dp_rank), setup.device)
    names = [n for n, _ in setup.model.named_parameters()]
    if _records_grads(ov, accum) or oracle == "agg":
        # step 0's gradients before any aggregation, or their aggregate
        grads, loss_sum, n_glob, _ = tts.local_grads(setup, b0)
        out["loss"] = (loss_sum / n_glob).item()
        if oracle == "agg":
            agg, _ = tagg.GradAggregator(setup.agg_cfg).aggregate_bucketed(
                [g.clone() for g in grads], agg0, setup.layout)
            for n, g in zip(names, agg):
                out[f"agg/{n}"] = g.float().numpy()
        else:
            for n, g in zip(names, grads):
                out[f"g/{n}"] = convert.to_global(setup.model, n, g).numpy()
        del grads
    step = tts.make_step(setup, accum)
    for s in range(STEPS):
        b = tts.split_batch(_batch(inp, key, s), p_dp, dp_rank)
        state, m = step(state, b, LR)
        for k in ("loss", "grad_norm"):
            out[f"{k}/{s}"] = m[k].item()
    for n, p in convert.global_params(setup.model).items():
        out[f"param/{n}"] = p.float().numpy()
    out["prints"] = np.asarray([fingerprint(p)
                                for p in setup.model.parameters()])
    out["replicated"] = np.asarray(setup.model_replicated())
    if setup.overlap:
        prints = _state_prints(state)
        setup2, state2 = _port_setup(tts, convert, key, ov, start)
        state2["agg"] = agg0
        sstep = overlap.make_step(setup2, "serial", accum)
        same = True
        for s in range(STEPS):
            b = tts.split_batch(_batch(inp, key, s), p_dp, dp_rank)
            state2, m = sstep(state2, b, LR)
            same &= m["loss"].item() == out[f"loss/{s}"]
        out["serial_equals_overlap"] = same and \
            _state_prints(state2) == prints
    # the global arrays: once per data rank (gradients), once (parameters)
    if out["coords"][1]:
        out = {k: v for k, v in out.items()
               if not k.startswith(("param/", "g/"))}
    elif dp_rank:
        out = {k: v for k, v in out.items() if not k.startswith("param/")}
    return out


def _run_torch(d, rank, port):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        mesh_mod.init_mesh(2, torch.device("cpu"))
        inp = np.load(os.path.join(d, "in.npz"))
        for case in CASES:
            np.savez(os.path.join(d, f"torch_{case}_{rank}.npz"),
                     **_port_case(inp, rank, case))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Runs every case on both sides; returns the directory."""
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("tp_recurrent"))
    _make_inputs(d)
    me = os.path.abspath(__file__)
    # LLVM's optimisation passes take ~40% of the JAX processes' CPU time
    # here, for programs that each run a few times
    xla = os.environ.get("XLA_FLAGS", "") \
        + f" --xla_force_host_platform_device_count={RANKS}" \
        + " --xla_backend_optimization_level=0"
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, me, "jax", d, part],
                              env=_env(XLA_FLAGS=xla, OMP_NUM_THREADS="1"),
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


def _ports(d, case):
    return [_load(d, f"torch_{case}_{r}") for r in range(RANKS)]


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if v[4] != "agg"])
def test_tp_recurrent_step_matches_jax_tp1(results, case):
    """Loss, grad norm and the parameters after the steps against JAX's
    step at ``tp = 1`` on the same global weights and batches."""
    key, tp, ov, _, oracle = CASES[case]
    jx = _load(results, f"jax_{oracle}")
    ports = _ports(results, case)
    zero1 = ov.get("zero1", False)
    for pt in ports:
        assert int(pt["tp"]) == tp
        assert bool(pt["sp"]) == ov.get("seq_parallel", True)
        for s in range(STEPS):
            np.testing.assert_allclose(pt[f"loss/{s}"], jx[f"loss/{s}"],
                                       rtol=1e-3 if zero1 else 1e-5,
                                       err_msg=f"{case} loss")
            rtol = (GNORM_DRIFT if s else 1e-2) if zero1 \
                else (GNORM_STEP_RTOL if s else 1e-5)
            np.testing.assert_allclose(pt[f"grad_norm/{s}"],
                                       jx[f"grad_norm/{s}"], rtol=rtol,
                                       err_msg=f"{case} grad norm")
    start = _start(np.load(os.path.join(results, "in.npz")), key)
    _assert_params(ports[0], jx, start, case)


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if _records_grads(v[2], v[3])])
def test_tp_recurrent_gradients_match_the_oracle(results, case):
    """Each leaf's step-0 gradient, per data rank, gathered over
    ``model``: JAX's ``tp = 1`` gradient of the same data rank's rows (at
    ``model 4`` the one data rank holds every row: the mean of JAX's
    two).  Without SP this sees a ``tp_copy`` left on the sLSTM (its
    leaves' and the stack's gradients summed twice), and a replicated
    leaf read without ``tp_shared`` (``in_bc``, ``conv_bc``, the mLSTM
    q/k/gate weights, the LoRA ``a``)."""
    key, tp, _, _, _ = CASES[case]
    jx = _load(results, f"jax_grads_{key}")
    n_leaves = 0
    for pt in _ports(results, case):
        if "g/embed.table" not in pt.files:
            continue                      # a model rank > 0
        d = int(pt["coords"][0])
        for k in (k for k in pt.files if k.startswith("g/")):
            want = jx[k][d] if tp == 2 else jx[k].mean(0)
            _assert_grads(pt[k], want, f"{case} {k} data {d}")
            n_leaves += 1
    assert n_leaves == len([k for k in jx.files if k.startswith("g/")]) \
        * (RANKS // tp)


def test_zero1_powersgd_over_shard_buckets_matches_jax(results):
    """The ZeRO-1 PowerSGD case: its first loss is the oracle's, and step
    0's PowerSGD aggregate over ``data`` of each model rank's bf16 shard
    buckets is JAX's aggregator's on the same buckets of the ``tp = 1``
    gradients, within ``BF16_AGG`` of the bucket's largest entry; the
    bucket layouts are the same."""
    case = _case_of("agg")
    jx = _load(results, "jax_agg")
    oracle = _load(results, f"jax_{CASES[case][0]}")
    for r, pt in enumerate(_ports(results, case)):
        np.testing.assert_allclose(pt["loss/0"], oracle["loss/0"],
                                   rtol=1e-5)
        assert list(pt["sizes"]) == list(jx["sizes"])
        keys = [k for k in pt.files if k.startswith("agg/")]
        assert len(keys) == len([k for k in jx.files
                                 if k.startswith("agg/")])
        top = max(np.abs(jx[k][r]).max() for k in keys)
        for k in keys:
            np.testing.assert_allclose(pt[k], jx[k][r], rtol=0,
                                       atol=BF16_AGG * top,
                                       err_msg=f"{k} rank {r}")


def test_mlstm_value_parts_match_jax_tp4_forward(results):
    """``n_heads = 2`` on ``model 4`` (each head's values over two ranks):
    the step-0 loss on every rank equals JAX's forward at ``tp = 4``, and
    so does the oracle's, JAX's ``tp = 1`` run with the grouped norm over
    the value parts (its gradients are held in the tests above)."""
    case = _case_of("ssm-r2")
    jx = _load(results, "jax_r2_forward")["loss"]
    oracle = _load(results, "jax_ssm-r2")
    np.testing.assert_allclose(oracle["loss/0"], jx[0], rtol=1e-5)
    for pt in _ports(results, case):
        assert int(pt["tp"]) == 4
        np.testing.assert_allclose(pt["loss"], jx[0], rtol=1e-5)
        np.testing.assert_allclose(pt["loss/0"], jx[0], rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_recurrent_replicas_hold_the_same_bits(results, case):
    """After the steps the ranks with the same model index hold the same
    bits (the DP replicas; under FSDP the ranks hold their own shards),
    every leaf replicated over ``model`` (the norms, the B/C projections,
    the mLSTM q/k/gates, every sLSTM leaf, the LoRA ``a``) holds the same
    bits on every rank, and the losses are the same everywhere."""
    ports = _ports(results, case)
    tp = CASES[case][1]
    fsdp = CASES[case][2].get("dp_mode") == "fsdp"
    for pt in ports:
        for s in range(STEPS):
            assert pt[f"loss/{s}"] == ports[0][f"loss/{s}"]
    rep = ports[0]["replicated"]
    assert rep.any()
    for pt in ports:
        d, m = (int(c) for c in pt["coords"])
        if not fsdp:
            np.testing.assert_array_equal(pt["prints"], ports[m]["prints"])
        # under FSDP a data rank holds its own shards (in_bc, lora.a)
        first = ports[d * tp] if fsdp else ports[0]
        np.testing.assert_array_equal(pt["prints"][rep],
                                      first["prints"][rep])
    if tp == 2 and not fsdp:      # the model ranks hold different shards
        assert not np.array_equal(ports[0]["prints"][~rep],
                                  ports[1]["prints"][~rep])


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if v[2].get("overlap")])
def test_tp_recurrent_serial_equals_overlap(results, case):
    for pt in _ports(results, case):
        assert bool(pt["serial_equals_overlap"])


@pytest.mark.parametrize("key, tp", [("hybrid", 2), ("hybrid", 4),
                                     ("ssm", 2), ("ssm", 4),
                                     ("ssm-r2", 4)])
def test_tp_dims_match_jax_specs(key, tp):
    """``Model.tp_dims`` and each leaf's global shape at ``tp``, leaf by
    leaf in leaf order, against JAX's ``abstract_init`` at
    ``ShardCtx(tp=tp)`` with FSDP over ``data``: the prefix rule keeps
    the sLSTM ``ffn.up``/``ffn.down`` and ``norm`` and the mLSTM ``conv``
    replicated where their last names are sharded elsewhere."""
    from test_torch_tp import _jax_specs

    from repro.configs import base as jcfgs
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_dims, param_layout, tp_dims
    dims, glob = _jax_specs(_arch(jcfgs, key), tp, fsdp=True)
    cfg = _arch(tcfgs, key)
    got = tp_dims(cfg, tp)
    assert list(got) == list(dims)
    for leaf, want in dims.items():
        assert (got[leaf],) == tuple(want["model"] or [None]), leaf
        assert (param_dims(cfg)[leaf],) == tuple(want["data"] or [None])
    assert [(n, s) for n, s, _ in param_layout(cfg, tp)] == \
        list(glob.items())
    sharded = {n for n, v in got.items() if v is not None}
    if key == "hybrid":
        assert "groups.mamba.norm" in sharded
        assert "groups.lora.wq.b" in sharded
        assert not {"groups.mamba.conv_bc", "groups.mamba.in_bc",
                    "groups.lora.wq.a"} & sharded
    else:
        assert {"groups.mlstm.norm", "groups.mlstm.up_v.w"} <= sharded
        assert not {n for n in got if n.startswith("groups.slstm.")} \
            & sharded
        assert "groups.mlstm.conv" not in sharded


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2], sys.argv[3])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), sys.argv[4])
