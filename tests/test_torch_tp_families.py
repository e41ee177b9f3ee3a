"""The ``model`` axis of the port (tensor and sequence parallelism) for
the audio and vlm families against the JAX package.

* Four ranks: the JAX package on 4 fake CPU devices in three
  subprocesses (``JAX_PARTS``: one per arch), the port on 4 gloo
  processes, all started together, each with ``OMP_NUM_THREADS=1``.  The
  port runs every case of ``CASES`` on ``data 2 x model 2``
  (``launch.mesh.init_mesh``) or on ``model 4``, ``STEPS`` steps at lr
  1e-3 from the same global parameters (drawn here with numpy, bf16
  values held in fp32, loaded with ``convert.load_params``) and the same
  global batches (``tokens``, ``labels`` and seeded fp32 ``enc_embeds``
  for the audio family; seeded fp32 ``embeds`` and three distinct M-RoPE
  position streams for the vlm family), computing in fp32, on the
  reduced ``seamless-m4t-medium`` (2 encoder and 2 decoder blocks, 4
  heads and 4 kv heads), the same with 2 kv heads (so ``model 4``
  replicates them) and the reduced ``qwen2-vl-7b`` (2 kv heads).
* The oracle is the JAX package's step at ``tp = 1`` on ``data 2`` with
  the same global weights and batches (its gradients at ``tp > 1`` are
  not its loss's: ``test_reference_tp_gradient_factors`` in
  ``test_torch_tp_step.py``):
  the loss, the grad norm, each leaf's step-0 gradient (before any
  aggregation, per data rank) and the parameters after the steps.  The
  ``accum = 2`` case is held to JAX's ``tp = 1`` step at ``accum = 2``.
  The ZeRO-1 PowerSGD case holds its first loss to the oracle's and its
  aggregated step-0 gradient to JAX's ``GradAggregator.aggregate_bucketed``
  over ``data`` on ``data 2 x model 2``, over the same bf16 shard buckets
  of JAX's ``tp = 1`` gradients (JAX's warm starts injected); its later
  steps compress other buckets than a ``tp = 1`` step, so no oracle
  follows them.
* On the same ranks: ``sp_scatter_embeds`` with and without SP, forward
  and backward, against JAX's under ``shard_map``.
* Every case: the ranks with the same model index hold the same bits
  after the steps, and so do the leaves replicated over ``model`` on
  every rank; the overlapped case's serial schedule gives the same bits.

Tolerances are ``test_torch_tp_step.py``'s: loss and grad norm
``rtol=1e-5``; per-leaf gradients within ``1e-4`` of the leaf's largest
entry; parameters by the FSDP rule (max difference at most ``2 * lr *
steps + 1e-4``, at most 2% of elements beyond ``lr / 2``, median at most
``lr / 50``); ``sp_scatter_embeds``: exact; replicas: bit for bit.  The
ZeRO-1 aggregate is bf16 (the ZeRO-1 buckets' dtype, in both packages):
it is held within ``BF16_AGG`` (two bf16 units, ``2**-7``) of the
bucket's largest entry, since an input or output one bf16 unit apart
(the packages' fp32 sums in another order, rounded) moves an entry by
up to one unit of the largest.

This file is also the subprocess script: ``python
test_torch_tp_families.py jax DIR PART`` or ``python
test_torch_tp_families.py torch DIR RANK PORT``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import test_torch_tp_step as tp_step
from test_torch_tp_step import (GLOBAL_BATCH, LR, RANKS, SEQ, STEPS,
                                _assert_grads, _assert_params, _batch, _env,
                                _jax_params, _load, _model_dims, _nest,
                                _start, _state_prints)

AUDIO, VLM = "seamless-m4t-medium", "qwen2-vl-7b"
#: arch key -> (registered arch, kv heads in place of the reduced config's)
ARCHS = {"audio": (AUDIO, None), "audio-kv2": (AUDIO, 2), "vlm": (VLM, None)}
BUCKET_MB = 0.0625
TIMEOUT_S = 300
#: the vlm batches: an image of IMAGE patches on a GRID-wide raster, then
#: text
IMAGE, GRID = 8, 4
#: the ZeRO-1 aggregate's limit, in units of the bucket's largest entry
BF16_AGG = 2.0 ** -7

#: case -> (arch key, tp, plan overrides beside bucket_mb, accum, the JAX
#: oracle run); every case but the FSDP one runs dp_mode="ddp"
CASES = {
    "a-audio-sp": ("audio", 2, dict(zero1=False), 1, "audio"),
    "b-audio-nosp": ("audio", 2, dict(zero1=False, seq_parallel=False), 1,
                     "audio"),
    "c-audio-sp-overlap": ("audio", 2, dict(zero1=False, overlap=True), 1,
                           "audio"),
    "d-audio-sp-accum2": ("audio", 2, dict(zero1=False), 2, "audio-accum2"),
    "e-audio-sp-remat": ("audio", 2, dict(zero1=False, remat="full"), 1,
                         "audio"),
    "f-audio-sp-zero1-powersgd": ("audio", 2, dict(
        zero1=True, compression="powersgd"), 1, "agg"),
    "g-vlm-sp": ("vlm", 2, dict(zero1=False), 1, "vlm"),
    "h-vlm-fsdp-sp": ("vlm", 2, dict(dp_mode="fsdp", zero1=False), 1, "vlm"),
    "i-audio-kv2-model4": ("audio-kv2", 4, dict(zero1=False), 1,
                           "audio-kv2"),
    "j-vlm-model4": ("vlm", 4, dict(zero1=False), 1, "vlm"),
}
#: the ``sp_scatter_embeds`` checks: (seq_parallel, per-device input shape)
SCATTER = [(False, (2, 8, 3)), (True, (2, 8, 3))]
#: the JAX subprocesses, run side by side: one per arch
JAX_PARTS = tuple(ARCHS)


def _arch(cfgs, key):
    name, kv = ARCHS[key]
    cfg = cfgs.reduced(cfgs.get(name))
    return dataclasses.replace(cfg, n_kv_heads=kv) if kv else cfg


def _agg_case():
    return next(c for c, v in CASES.items() if v[4] == "agg")


def _port_layout_sizes():
    """Bucket sizes of the port's ZeRO-1 layout over the local shards of
    a rank of ``data 2 x model 2`` (bf16 parameters; no allocation)."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.core import bucketing
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    model = Model(_arch(tcfgs, "audio"), ShardCtx(
        param_dtype=torch.bfloat16, tp=2, seq_parallel=True), device="meta")
    return bucketing.layout_for(list(model.parameters()), BUCKET_MB).sizes


# ------------------------------------------------------------ the inputs
def _make_inputs(d):
    """in.npz: per arch key the start parameters (global, bf16 values
    held in fp32) and the global batches; the PowerSGD warm starts JAX's
    ``init_state`` draws for the ZeRO-1 shard buckets; the
    ``sp_scatter_embeds`` inputs and cotangents."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    from repro.core.compression import base as jbase
    from repro.data.synthetic import DataConfig, batch_at
    from repro_torch.configs import base as tcfgs
    from repro_torch.launch.inputs import vlm_positions
    from repro_torch.models.model import param_layout
    rng = np.random.default_rng(37)
    arrays = {}
    for key in ARCHS:
        cfg = _arch(tcfgs, key)
        for leaf, shape, init in param_layout(cfg):
            value = np.ones(shape) if init is None \
                else init * np.clip(rng.standard_normal(shape), -3, 3)
            arrays[f"param/{key}/{leaf}"] = np.asarray(
                jnp.asarray(value, jnp.bfloat16), np.float32)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                          global_batch=GLOBAL_BATCH)
        for s in range(STEPS):
            b = batch_at(dcfg, s)
            for k in ("tokens", "labels"):
                arrays[f"batch/{key}/{s}/{k}"] = b[k]
            frames = rng.standard_normal(
                (GLOBAL_BATCH, SEQ, cfg.d_model)).astype(np.float32)
            if cfg.family == "audio":
                arrays[f"batch/{key}/{s}/enc_embeds"] = frames
            else:
                arrays[f"batch/{key}/{s}/embeds"] = frames
                arrays[f"batch/{key}/{s}/mrope_positions"] = vlm_positions(
                    GLOBAL_BATCH, SEQ, IMAGE, GRID).numpy().astype(np.int32)
    plan = dataclasses.replace(_arch(jcfgs, "audio").plan,
                               **CASES[_agg_case()][2])
    comp = jbase.make(plan.compression, **jbase.plan_kwargs(plan))
    sizes = _port_layout_sizes()
    keys = jax.random.split(jax.random.fold_in(jax.random.key(0), 7),
                            len(sizes))
    for i, (n, k) in enumerate(zip(sizes, keys)):
        arrays[f"q/{i}"] = np.asarray(comp.init_state(n, k).q)
    for i, (sp, shape) in enumerate(SCATTER):
        arrays[f"sx/{i}"] = rng.standard_normal((RANKS, *shape)).astype(
            np.float32)
        out = (shape[0], shape[1] // 2, *shape[2:]) if sp else shape
        arrays[f"sct/{i}"] = rng.standard_normal((RANKS, *out)).astype(
            np.float32)
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
    """The oracle run: ``STEPS`` steps from ``start``; its losses, grad
    norms and final parameters."""
    import jax
    import jax.numpy as jnp
    state = jts.init_state(setup, jax.random.key(0))

    def put(path, x):
        leaf = ".".join(str(k.key) for k in path)
        return jax.device_put(jnp.asarray(start[leaf], x.dtype), x.sharding)
    state["params"] = jax.tree_util.tree_map_with_path(put, state["params"])
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


def _run_jax_scatter(inp, mesh):
    """JAX ``sp_scatter_embeds`` on every device of ``data 2 x model 2``:
    its output and the gradient of the cotangent."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.models import layers as jl
    from repro.models import transformer as jtf
    from repro.parallel.compat import shard_map
    out = {}
    every = ("data", "model")
    for i, (sp, _) in enumerate(SCATTER):
        ctx = jl.ShardCtx(tp=2, seq_parallel=sp)

        def run(x, ct, ctx=ctx):
            y, vjp = jax.vjp(lambda z: jtf.sp_scatter_embeds(z, ctx), x[0])
            (g,) = vjp(ct[0])
            return y[None], g[None]
        f = shard_map(run, mesh, in_specs=(P(every), P(every)),
                      out_specs=(P(every), P(every)))
        y, g = jax.jit(f)(jnp.asarray(inp[f"sx/{i}"]),
                          jnp.asarray(inp[f"sct/{i}"]))
        out[f"y/{i}"], out[f"g/{i}"] = np.asarray(y), np.asarray(g)
    return out


def _run_jax_agg(d, inp, jts, mesh2, grads):
    """PowerSGD over ``data`` on each model rank's ZeRO-1 shard buckets
    (bf16) of the ``tp = 1`` gradients (``data 2 x model 2``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import aggregator as jagg
    from repro.core.compression import powersgd as jpsgd
    from repro.parallel.compat import shard_map
    setup2 = _jax_setup(jts, mesh2, "audio", **CASES[_agg_case()][2])
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


def _run_jax(d, key):
    """The oracle runs of one arch key (``tp = 1`` on ``data 2``), its
    per-data-rank gradients of step 0, and for the audio arch the
    PowerSGD aggregate over the ZeRO-1 shard buckets; the vlm part also
    runs the ``sp_scatter_embeds`` checks."""
    import jax
    from jax.sharding import Mesh

    from repro.parallel.compat import make_mesh
    from repro.train import train_step as jts
    assert len(jax.devices()) == RANKS
    inp = np.load(os.path.join(d, "in.npz"))
    mesh1 = Mesh(np.array(jax.devices()[:2]).reshape(2, 1),
                 ("data", "model"))
    mesh2 = make_mesh((2, 2), ("data", "model"))
    start = _start(inp, key)
    for run in {v[4] for v in CASES.values()
                if v[4] in (key, key + "-accum2")}:
        setup = _jax_setup(jts, mesh1, key, zero1=False)
        accum = 2 if run.endswith("accum2") else 1
        np.savez(os.path.join(d, f"jax_{run}.npz"),
                 **_jax_steps(jts, setup, start, inp, key, accum))
    setup = _jax_setup(jts, mesh1, key, zero1=False)
    g, ls, _ = tp_step._device_grads(setup, _jax_params(setup, start),
                                     _batch(inp, key, 0))
    grads = {f"g/{k}": v for k, v in g.items()}
    np.savez(os.path.join(d, f"jax_grads_{key}.npz"), loss_sum=ls, **grads)
    if key == "audio":
        _run_jax_agg(d, inp, jts, mesh2, grads)
    if key == "vlm":
        np.savez(os.path.join(d, "jax_scatter.npz"),
                 **_run_jax_scatter(inp, mesh2))


# ------------------------------------------------------------ port side
def _port_scatter(inp, rank):
    import torch

    from repro_torch.models import layers as tl
    out = {}
    for i, (sp, _) in enumerate(SCATTER):
        x = torch.from_numpy(inp[f"sx/{i}"][rank].copy()).requires_grad_()
        y = tl.sp_scatter_embeds(x, tl.ShardCtx(tp=2, seq_parallel=sp))
        (g,) = torch.autograd.grad(y, x, torch.from_numpy(
            inp[f"sct/{i}"][rank].copy()))
        out[f"y/{i}"], out[f"g/{i}"] = y.detach().numpy(), g.numpy()
    return out


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


def _records_grads(ov, accum):
    """Do the case's ranks record step-0 gradients?  (replicated DDP
    parameters, one microbatch)"""
    return not ov.get("zero1") and ov.get("dp_mode", "ddp") == "ddp" \
        and accum == 1


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
        grads, loss_sum, _, _ = tts.local_grads(setup, b0)
        out["loss_sum"] = loss_sum.item()
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
        np.savez(os.path.join(d, f"torch_scatter_{rank}.npz"),
                 **_port_scatter(inp, rank))
        for case in CASES:
            np.savez(os.path.join(d, f"torch_{case}_{rank}.npz"),
                     **_port_case(inp, rank, case))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Runs every case on both sides; returns the directory."""
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("tp_families"))
    _make_inputs(d)
    me = os.path.abspath(__file__)
    xla = os.environ.get("XLA_FLAGS", "") \
        + f" --xla_force_host_platform_device_count={RANKS}"
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
def test_tp_family_step_matches_jax_tp1(results, case):
    """Loss, grad norm and the parameters after the steps against JAX's
    step at ``tp = 1`` on the same global weights and batches."""
    key, tp, ov, _, oracle = CASES[case]
    jx = _load(results, f"jax_{oracle}")
    ports = _ports(results, case)
    for pt in ports:
        assert int(pt["tp"]) == tp
        assert bool(pt["sp"]) == ov.get("seq_parallel", True)
        for s in range(STEPS):
            np.testing.assert_allclose(pt[f"loss/{s}"], jx[f"loss/{s}"],
                                       rtol=1e-5, err_msg=f"{case} loss")
            np.testing.assert_allclose(pt[f"grad_norm/{s}"],
                                       jx[f"grad_norm/{s}"], rtol=1e-5,
                                       err_msg=f"{case} grad norm")
    start = _start(np.load(os.path.join(results, "in.npz")), key)
    _assert_params(ports[0], jx, start, case)


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if _records_grads(v[2], v[3])])
def test_tp_family_gradients_match_the_oracle(results, case):
    """Each leaf's step-0 gradient, per data rank, gathered over
    ``model``: JAX's ``tp = 1`` gradient of the same data rank's rows (at
    ``model 4`` the one data rank holds every row: the mean of JAX's
    two).  The encoder's and ``enc_norm``'s gradients are whole only
    where the memory's partial gradients are summed over ``model``."""
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
    case = _agg_case()
    jx = _load(results, "jax_agg")
    oracle = _load(results, "jax_audio")
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


@pytest.mark.parametrize("case", list(CASES))
def test_tp_family_replicas_hold_the_same_bits(results, case):
    """After the steps the ranks with the same model index hold the same
    bits (the DP replicas; under FSDP the ranks hold their own shards),
    every leaf replicated over ``model`` (the norms, ``enc_norm``, the kv
    weights at ``model 4``) holds the same bits on every rank, and the
    losses are the same everywhere."""
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
def test_tp_family_serial_equals_overlap(results, case):
    for pt in _ports(results, case):
        assert bool(pt["serial_equals_overlap"])


def test_sp_scatter_embeds_matches_jax(results):
    """``sp_scatter_embeds`` equals JAX's under ``shard_map`` on every
    device of ``data 2 x model 2``, forward and backward: under SP each
    model rank's slice of the sequence and the zero-padded gradient,
    without SP the input and the cotangent."""
    jx = _load(results, "jax_scatter")
    for r in range(RANKS):
        pt = _load(results, f"torch_scatter_{r}")
        for i, case in enumerate(SCATTER):
            np.testing.assert_array_equal(pt[f"y/{i}"], jx[f"y/{i}"][r],
                                          err_msg=f"{case} y rank {r}")
            np.testing.assert_array_equal(pt[f"g/{i}"], jx[f"g/{i}"][r],
                                          err_msg=f"{case} g rank {r}")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2], sys.argv[3])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), sys.argv[4])
