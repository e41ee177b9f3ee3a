"""The two-tier ``pod x data`` mesh (``launch.mesh.init_pod_mesh``), the
``hierarchical`` comm plan, ``compress_axes`` ``"pod"``/``"all"``, local
SGD and the pod worker: the port against the JAX package.

* Four ranks as pod 2 x data 2: JAX on 4 fake CPU devices in one
  subprocess (mesh ``(2, 2, 1)`` over ``("pod", "data", "model")``), the
  port on 4 gloo processes joined by ``init_pod_mesh(2, 2)``, all started
  together.  World rank ``r`` is JAX's device ``r``: ``pod = r // 2``,
  ``data = r % 2``.
* Aggregator level (``tests/dist/dist_commplan_equivalence.py``'s oracle
  on the port): one 5003-element fp32 bucket per rank, drawn here with
  numpy, meaned over ``("pod", "data")`` by ``allreduce``,
  ``reduce_scatter_allgather``, ``gather_all`` and ``hierarchical``.  Each
  matches JAX's value (``rtol=1e-6, atol=1e-7``: gloo and XLA sum in
  their own orders); on the port ``allreduce`` and
  ``reduce_scatter_allgather`` give the same bits, ``hierarchical`` and
  ``gather_all`` are within that tolerance of ``allreduce``, and the
  asynchronous means (``mean_reduce_async``) give the bits of the
  synchronous ones.
* Train level, 3 steps of the reduced ``tinyllama-1.1b`` (ZeRO-1, fp32
  compute, bf16 parameters drawn here with numpy) against JAX's
  overlapped step on the same mesh: ``none`` under ``hierarchical:data``
  with ``compress_axes="all"`` (the port's overlapped, serial and classic
  steps; ``serial == overlap`` bit for bit), PowerSGD with
  ``compress_axes="pod"`` (a raw mean over ``data``, the compressor over
  ``pod``; JAX's warm starts loaded into the port) and SignSGD with
  ``compress_axes="all"`` (p = 4, runs ``serial``), and
  ``reduce_to_owner_broadcast`` (ZeRO-1's owner-aligned reduce-scatter
  over ``("pod", "data")``, runs ``raw``).  Tolerances are
  ``tests/test_torch_overlap.py``'s (its docstring).
* Local SGD: ``sync_every=2``, 4 steps of the classic ZeRO-1 step through
  each package's ``Trainer`` with ``local_sgd_sync``: the same tolerances
  (the parameters' bound for 4 steps); on the port the parameters hold the
  same bits on both pods after each sync.  In both packages the sync
  leaves the parameters' bits as they were: the step already averages the
  gradient over ``pod``, so the pods' parameters are equal before it.
* Refusals, as in JAX: ``build`` raises ``CommPlanError`` for a
  ``hierarchical`` plan whose ``intra`` names no reduction axis;
  ``from_plan`` gives JAX's axes for every compressor, both
  ``compress_axes`` values and one or several pods.
* The entry points on 4 gloo ranks: ``pod_worker --json`` prints one
  record with the JAX worker's keys; the launcher runs ``--mesh pod``.
* ``kernels/build.py``'s lock: two processes reaching first use at once
  build once, in turn (a stub in place of ``nvcc``).

This file is also the subprocess script: ``python test_torch_pod.py jax
DIR`` or ``python test_torch_pod.py torch DIR RANK PORT``.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
LR = 1e-3
STEPS = 3
SYNC_STEPS = 4
SYNC_EVERY = 2
GLOBAL_BATCH = 8
SEQ = 32
BUCKET_MB = 0.125            # 6 bf16 leaf-aligned buckets
N = 5003                     # not a multiple of 4: the rs+ag padding
TIMEOUT_S = 300
VOTE_SHARE = 1e-3
KINDS = ("allreduce", "reduce_scatter_allgather", "gather_all",
         "hierarchical")

#: case -> plan overrides (the arch's zero1=True, the overlapped step)
CASES = {
    "a-hier-none": dict(compression="none", comm="hierarchical:data",
                        compress_axes="all"),
    "b-powersgd-pod": dict(compression="powersgd", compress_axes="pod"),
    "c-signsgd-all": dict(compression="signsgd", compress_axes="all"),
    # ZeRO-1's owner-aligned reduce-scatter over ("pod", "data"); runs raw
    "d-rtob": dict(compression="none", comm="reduce_to_owner_broadcast"),
}
#: the local-SGD case: the classic ZeRO-1 step, uncompressed
SYNC_CASE = dict(compression="none", overlap=False)
#: a hierarchical plan whose intra stage names no reduction axis
BAD_HIER = dict(compression="none", comm="hierarchical:model")


def _reduced(cfgs):
    return cfgs.reduced(cfgs.get("tinyllama-1.1b"))


def _nest(flat):
    """{dotted path: value} -> nested dicts."""
    out = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


# ------------------------------------------------------------ the inputs
def _make_inputs(d):
    """in.npz: the buckets of the aggregator level, the start parameters
    (bf16 values held in fp32), the global batches and PowerSGD's warm
    starts as JAX's ``init_state`` draws them (``q/<bucket>``)."""
    import jax
    import torch

    from repro.configs import base as jcfgs
    from repro.core.compression import base as jbase
    from repro.data.synthetic import DataConfig, batch_at
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model, param_layout
    from repro_torch.train import overlap
    rng = np.random.default_rng(17)
    arrays = {"bucket": rng.standard_normal((RANKS, N)).astype(np.float32)}
    cfg = _reduced(tcfgs)
    for name, shape, std in param_layout(cfg):
        a = np.ones(shape) if std is None else std * np.clip(
            rng.standard_normal(shape), -3, 3)
        arrays[f"param/{name}"] = np.asarray(
            jax.numpy.asarray(a, jax.numpy.bfloat16), np.float32)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=GLOBAL_BATCH)
    for s in range(SYNC_STEPS):
        for k, v in batch_at(dcfg, s).items():
            arrays[f"{k}/{s}"] = v
    plan = dataclasses.replace(_reduced(jcfgs).plan, compression="powersgd")
    comp = jbase.make(plan.compression, **jbase.plan_kwargs(plan))
    sizes = overlap.layout_for_model(
        Model(cfg, ShardCtx(param_dtype=torch.bfloat16), device="meta"),
        BUCKET_MB).layout.sizes
    keys = jax.random.split(jax.random.fold_in(jax.random.key(0), 7),
                            len(sizes))
    for i, (n, k) in enumerate(zip(sizes, keys)):
        arrays[f"q/{i}"] = np.asarray(comp.init_state(n, k).q)
    np.savez(os.path.join(d, "in.npz"), **arrays)


def _start_params(inp):
    return {k.split("/", 1)[1]: inp[k] for k in inp.files
            if k.startswith("param/")}


def _batch(inp, step, rank=None):
    b = {k: inp[f"{k}/{step}"] for k in ("tokens", "labels")}
    if rank is None:
        return b
    per = GLOBAL_BATCH // RANKS
    return {k: v[rank * per:(rank + 1) * per] for k, v in b.items()}


# ------------------------------------------------------------- JAX side
def _jax_setup(jcfgs, jts, mesh, inp, **overrides):
    """A JAX setup on ``mesh`` at fp32 compute with the start parameters
    (ZeRO-1's master filled from them)."""
    import jax
    import jax.numpy as jnp
    setup = jts.build(_reduced(jcfgs), mesh, bucket_mb=BUCKET_MB,
                      **{"overlap": True, **overrides})
    setup.ctx = dataclasses.replace(setup.ctx, compute_dtype=jnp.float32)
    state = jts.init_state(setup, jax.random.key(0))
    start = _start_params(inp)

    def put(path, x):
        name = ".".join(str(k.key) for k in path)
        return jax.device_put(jnp.asarray(start[name], x.dtype), x.sharding)
    state["params"] = jax.tree_util.tree_map_with_path(put, state["params"])
    if setup.zero1:
        state = jts._fill_zero1_master(setup, state,
                                       jts._bucket_layout(setup))
    return setup, state


def _jax_dump(setup, host, out):
    import jax
    for path, x in jax.tree_util.tree_flatten_with_path(host["params"])[0]:
        name = ".".join(str(k.key) for k in path)
        out[f"param/{name}"] = np.asarray(x, np.float32)
    if setup.zero1:
        out["t"] = np.asarray(host["opt"]["t"])
        for k in ("master", "m", "v"):
            out[f"shard/{k}"] = np.asarray(host["opt"]["shard"][k])


def _run_jax(d):
    """The aggregator level, every case's overlapped step, local SGD and
    the refusal on the pod mesh; writes jax_*.npz."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import base as jcfgs
    from repro.parallel import commplan as jcp
    from repro.parallel.compat import make_mesh, shard_map
    from repro.train import overlap as jov
    from repro.train import train_step as jts
    from repro.train.schedule import ScheduleConfig
    from repro.train.trainer import Trainer, TrainerConfig
    assert len(jax.devices()) == RANKS
    inp = np.load(os.path.join(d, "in.npz"))

    # ---- aggregator level
    mesh2 = make_mesh((2, 2), ("pod", "data"))
    axes = ("pod", "data")

    def run(gl):
        gl = gl.reshape(-1)
        return tuple(jcp.mean_reduce(gl, axes, jcp.CommPlan(k))[None]
                     for k in KINDS)
    f = shard_map(run, mesh2, in_specs=(P(axes),),
                  out_specs=tuple(P(axes) for _ in KINDS))
    outs = jax.jit(f)(jnp.asarray(inp["bucket"]))
    np.savez(os.path.join(d, "jax_agg.npz"),
             **{k: np.asarray(o) for k, o in zip(KINDS, outs)})

    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
    # ---- the train cases
    for case, overrides in CASES.items():
        setup, state = _jax_setup(jcfgs, jts, mesh, inp, **overrides)
        out = {"schedule": jov.effective_schedule(setup),
               "compress_axes": list(setup.agg_cfg.compress_axes),
               "raw_axes": list(setup.agg_cfg.raw_axes)}
        if case == "b-powersgd-pod":
            for i, st in enumerate(state["agg"]):
                np.testing.assert_array_equal(np.asarray(st.q)[0],
                                              inp[f"q/{i}"])
        step = jts.make_step(setup)(_batch(inp, 0))
        for s in range(STEPS):
            state, m = step(state, _batch(inp, s), jnp.float32(LR))
            m = jax.device_get(m)
            out[f"loss/{s}"], out[f"grad_norm/{s}"] = m["loss"], \
                m["grad_norm"]
        _jax_dump(setup, jax.device_get(state), out)
        np.savez(os.path.join(d, f"jax_{case}.npz"), **out)
        print(f"jax {case} done", flush=True)

    # ---- local SGD through the Trainer
    setup, state = _jax_setup(jcfgs, jts, mesh, inp, **SYNC_CASE)
    trainer = Trainer(setup, TrainerConfig(
        total_steps=SYNC_STEPS, log_every=0, sync_every=SYNC_EVERY,
        schedule=ScheduleConfig(peak_lr=LR, warmup_steps=1,
                                total_steps=SYNC_STEPS)),
        iter([_batch(inp, s) for s in range(SYNC_STEPS)]), state=state)
    sync = jts.local_sgd_sync(setup)
    kept = []

    def recording(st):
        before = jax.device_get(st["params"])
        st = sync(st)
        after = jax.device_get(st["params"])
        kept.append(all(np.array_equal(np.asarray(a), np.asarray(b))
                        for a, b in zip(jax.tree.leaves(before),
                                        jax.tree.leaves(after))))
        return st
    trainer.sync_fn = recording
    state = trainer.run()
    out = {"kept": np.asarray(kept)}
    _jax_dump(setup, jax.device_get(state), out)
    np.savez(os.path.join(d, "jax_sync.npz"), **out)

    # ---- the refusal
    try:
        jts.build(_reduced(jcfgs), mesh, **BAD_HIER)
        err = ""
    except ValueError as e:
        err = type(e).__name__
    np.savez(os.path.join(d, "jax_refusal.npz"), error=err)
    print("jax done", flush=True)


# ------------------------------------------------------------ port side
def _bits(t):
    """A tensor's raw bits as a numpy array (bf16 as int16, fp32 as
    int32), so equal arrays mean the same bits."""
    import torch
    t = t.detach().cpu().contiguous()
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(
        t.dtype)
    return (t.view(view) if view else t).numpy()


def _port_setup(inp, **overrides):
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.train import train_step as tts
    setup = tts.build(_reduced(tcfgs), "cpu", bucket_mb=BUCKET_MB,
                      **{"overlap": True, **overrides})
    setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                          compute_dtype=torch.float32)
    state = tts.init_state(setup)
    convert.load_params(setup.model, _nest(_start_params(inp)))
    if setup.zero1:
        state = tts._fill_zero1_master(setup, state)
    if setup.agg_cfg.compressor == "powersgd":
        comp = setup.agg_cfg.build()
        state["agg"] = convert.agg_states(
            comp, [{"q": inp[f"q/{i}"], "err": np.zeros(n, np.float32)}
                   for i, n in enumerate(setup.layout.sizes)], index=None)
    return setup, state


def _port_dump(setup, state, out):
    for name, p in setup.model.named_parameters():
        out[f"param/{name}"] = p.detach().float().numpy()
        out[f"bits/param/{name}"] = _bits(p)
    if setup.zero1:
        out["t"] = state["opt"]["t"]
        for k, v in state["opt"]["shard"].items():
            out[f"shard/{k}"] = v.numpy()
            out[f"bits/shard/{k}"] = _bits(v)


def _run_port_case(inp, rank, case, schedule):
    from repro_torch.train import overlap
    from repro_torch.train import train_step as tts
    setup, state = _port_setup(inp, **CASES[case],
                               overlap=schedule != "classic")
    if schedule == "classic":
        step = tts.make_step(setup)
    else:
        step = overlap.make_step(setup, schedule)
    out = {"schedule": overlap.effective_schedule(setup),
           "compress_axes": list(setup.agg_cfg.compress_axes),
           "raw_axes": list(setup.agg_cfg.raw_axes),
           "dp_axes": list(setup.dp_axes)}
    for s in range(STEPS):
        state, m = step(state, _batch(inp, s, rank), LR)
        for k in ("loss", "grad_norm", "tokens"):
            out[f"{k}/{s}"] = m[k].item()
            out[f"bits/{k}/{s}"] = _bits(m[k])
    _port_dump(setup, state, out)
    for b, st in enumerate(state["agg"]):
        for field, t in zip(st._fields, st):
            out[f"bits/agg/{b}/{field}"] = _bits(t)
    return out


def _run_port_sync(inp, rank):
    import torch

    from repro_torch.train import train_step as tts
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    setup, state = _port_setup(inp, **SYNC_CASE)
    trainer = Trainer(setup, TrainerConfig(
        total_steps=SYNC_STEPS, log_every=0, sync_every=SYNC_EVERY,
        schedule=ScheduleConfig(peak_lr=LR, warmup_steps=1,
                                total_steps=SYNC_STEPS)),
        iter([_batch(inp, s, rank) for s in range(SYNC_STEPS)]), state=state)
    sync = tts.local_sgd_sync(setup)
    kept, agree = [], []

    def recording(st):
        before = [p.detach().clone() for p in st["params"]]
        st = sync(st)
        kept.append(all(torch.equal(_t(a), _t(b)) for a, b in
                        zip(before, st["params"])))
        agree.append(tts.params_agree(st["params"], ("pod",)))
        return st
    trainer.sync_fn = recording
    state = trainer.run()
    out = {"kept": np.asarray(kept), "agree": np.asarray(agree),
           "synced": np.asarray([r["synced"] for r in trainer.history])}
    for s, r in enumerate(trainer.history):
        out[f"loss/{s}"] = r["loss"]
    _port_dump(setup, state, out)
    return out


def _t(x):
    """bf16 bits as int16, so ``torch.equal`` compares bits."""
    import torch
    return x.detach().view(torch.int16) if x.dtype == torch.bfloat16 else x


def _run_torch(d, rank, port):
    """One gloo rank of the pod mesh: every run; writes torch_*_<rank>.npz."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import commplan as cp
    from repro_torch.train import train_step as tts
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        pm = mesh_mod.init_pod_mesh(2, 2, torch.device("cpu"))
        inp = np.load(os.path.join(d, "in.npz"))
        out = {"coords": [mesh_mod.coords()[a] for a in ("pod", "data")],
               "rank_pd": mesh_mod.rank(("pod", "data")),
               "rank_dp": mesh_mod.rank(("data", "pod")),
               "rank_pod": mesh_mod.rank(("pod",)),
               "rank_data": mesh_mod.rank(("data",)),
               "sizes": [mesh_mod.axis_sizes()[a] for a in ("pod", "data")],
               "group_sizes": [dist.get_world_size(pm.groups[a])
                               for a in ("pod", "data")],
               "backends": json.dumps(mesh_mod.backends(), sort_keys=True),
               "present": list(mesh_mod.present_axes())}
        # ---- aggregator level
        g = torch.from_numpy(inp["bucket"][rank].copy())
        axes = ("pod", "data")
        for k in KINDS:
            plan = cp.CommPlan(k)
            out[f"mean/{k}"] = cp.mean_reduce(g, axes, plan).numpy()
            if k in cp.ASYNC_KINDS:
                out[f"async/{k}"] = cp.mean_reduce_async(g, axes, plan) \
                    .wait().numpy()
        hier = cp.CommPlan("hierarchical", intra=("data",))
        out["async_poll"] = _poll_then_wait(cp.mean_reduce_async(
            g, ("data", "pod"), hier)).numpy()
        out["sync_dp"] = cp.mean_reduce(g, ("data", "pod"), hier).numpy()
        np.savez(os.path.join(d, f"torch_agg_{rank}.npz"), **out)
        # ---- the train cases
        for case in CASES:
            runs = ["overlap", "serial"] + (["classic"] if case ==
                                            "a-hier-none" else [])
            for schedule in runs:
                res = _run_port_case(inp, rank, case, schedule)
                np.savez(os.path.join(
                    d, f"torch_{case}_{schedule}_{rank}.npz"), **res)
        np.savez(os.path.join(d, f"torch_sync_{rank}.npz"),
                 **_run_port_sync(inp, rank))
        # ---- the refusal
        from repro_torch.configs import base as tcfgs
        try:
            tts.build(_reduced(tcfgs), "cpu", **BAD_HIER)
            err = ""
        except ValueError as e:
            err = type(e).__name__
        np.savez(os.path.join(d, f"torch_refusal_{rank}.npz"), error=err)
    finally:
        dist.destroy_process_group()


def _poll_then_wait(mean):
    """Poll a mean in flight until it is done, as the flush engine does
    between stages, then take its value."""
    import time
    deadline = time.monotonic() + 60
    while not mean.poll():
        assert time.monotonic() < deadline, "the mean never completed"
        time.sleep(0.001)
    return mean.wait()


# ------------------------------------------------------------- fixtures
def _env(**extra):
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


#: the entry points' runs on 4 gloo ranks: ``torchrun ... -m <module> ...``
CLI_RUNS = {
    "worker": ("repro_torch.train.pod_worker", "--device", "cpu", "--procs",
               "2", "--local-devices", "2", "--zero1", "--method",
               "powersgd", "--batch", "8", "--seq", "16", "--bucket-mb",
               "0.125", "--reps", "1", "--warmup", "1", "--json"),
    "launcher": ("repro_torch.launch.train", "--device", "cpu", "--mesh",
                 "pod", "--procs", "2", "--local-devices", "2",
                 "--compress-axes", "pod", "--compression", "powersgd",
                 "--overlap", "--steps", "2", "--batch", "8", "--seq", "16",
                 "--sync-every", "2", "--log-every", "1"),
}


@pytest.fixture(scope="module")
def cli():
    """Starts every run of ``CLI_RUNS`` at once; ``cli(name)`` waits for
    one and returns its standard output."""
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(RANKS), "-m", *args],
        env=_env(OMP_NUM_THREADS="1"), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, args in CLI_RUNS.items()}
    outs = {}

    def result(name):
        if name not in outs:
            out, err = procs[name].communicate(timeout=TIMEOUT_S)
            assert procs[name].returncode == 0, out[-2000:] + err[-3000:]
            outs[name] = out
        return outs[name]
    yield result
    for p in procs.values():
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def results(tmp_path_factory, cli):
    """Runs everything on both sides (the entry points' runs of ``cli``
    start first and run beside them)."""
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("pod"))
    _make_inputs(d)
    me = os.path.abspath(__file__)
    xla = os.environ.get("XLA_FLAGS", "") \
        + f" --xla_force_host_platform_device_count={RANKS}"
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, me, "jax", d],
                              env=_env(XLA_FLAGS=xla), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, me, "torch", d, str(r), port],
                               env=_env(OMP_NUM_THREADS="1"),
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


def _ports(d, name):
    return [_load(d, f"torch_{name}_{r}") for r in range(RANKS)]


def _assert_close_to_lr(got, want, what, steps=STEPS):
    """The rule of tests/test_torch_train.py for values that AdamW moved
    ``steps`` times by about ``LR``."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * steps + 1e-4, (what, diff.max())
    assert (diff > LR / 2).mean() <= 0.02, (what, (diff > LR / 2).mean())
    assert np.median(diff) <= LR / 50, (what, np.median(diff))


def _assert_state_matches(pt, jx, r, what, steps=STEPS, signs=False,
                          shards=True):
    """Parameters and, under ZeRO-1 with ``shards``, rank ``r``'s shards
    against JAX's."""
    names = [k for k in jx.files if k.startswith("param/")]
    assert sorted(names) == sorted(k for k in pt.files
                                   if k.startswith("param/"))
    for k in names:
        _assert_close_to_lr(pt[k], jx[k], f"{what} {k} rank {r}", steps)
    if "t" not in jx.files or not shards:
        return
    assert int(pt["t"]) == int(jx["t"]) == steps
    _assert_close_to_lr(pt["shard/master"], jx["shard/master"][r],
                        f"{what} master rank {r}", steps)
    for k in ("m", "v"):
        got, want = pt[f"shard/{k}"], jx[f"shard/{k}"][r]
        if signs and k == "m":
            flipped = np.abs(got - want) > 1e-3 * np.abs(want).max()
            assert flipped.mean() <= VOTE_SHARE, (r, flipped.sum())
        else:
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert rel <= 1e-2, (what, k, r, rel)


# ------------------------------------------------------- the mesh itself
def test_pod_mesh_is_pod_major_with_one_group_per_row_and_column(results):
    for r, pt in enumerate(_ports(results, "agg")):
        assert list(pt["coords"]) == [r // 2, r % 2]
        assert int(pt["rank_pd"]) == r
        assert int(pt["rank_dp"]) == (r % 2) * 2 + r // 2
        assert (int(pt["rank_pod"]), int(pt["rank_data"])) == (r // 2, r % 2)
        assert list(pt["sizes"]) == list(pt["group_sizes"]) == [2, 2]
        assert json.loads(str(pt["backends"])) == {
            "pod": "gloo", "data": "gloo", "world": "gloo"}
        assert list(pt["present"]) == ["pod", "data"]


# ------------------------------------------------- the aggregator level
@pytest.mark.parametrize("kind", KINDS)
def test_each_plan_matches_jax_on_the_pod_mesh(results, kind):
    """Each rank's mean against JAX's and against the float64 mean of the
    four buckets."""
    want = _load(results, "jax_agg")[kind]
    assert want.shape == (RANKS, N)
    exact = _load(results, "in")["bucket"].astype(np.float64).mean(0)
    for r, pt in enumerate(_ports(results, "agg")):
        np.testing.assert_allclose(pt[f"mean/{kind}"], want[r], rtol=1e-6,
                                   atol=1e-7, err_msg=f"{kind} rank {r}")
        np.testing.assert_allclose(pt[f"mean/{kind}"], exact, rtol=1e-6,
                                   atol=1e-7, err_msg=f"{kind} rank {r}")


def test_ring_plans_give_the_same_bits_and_the_others_are_fp_close(results):
    for pt in _ports(results, "agg"):
        ref = pt["mean/allreduce"]
        np.testing.assert_array_equal(
            pt["mean/reduce_scatter_allgather"].view(np.int32),
            ref.view(np.int32))
        for k in ("hierarchical", "gather_all"):
            np.testing.assert_allclose(pt[f"mean/{k}"], ref, rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_asynchronous_means_give_the_synchronous_bits(results):
    from repro_torch.parallel import commplan as cp
    for pt in _ports(results, "agg"):
        for k in cp.ASYNC_KINDS:
            np.testing.assert_array_equal(pt[f"async/{k}"].view(np.int32),
                                          pt[f"mean/{k}"].view(np.int32))
        np.testing.assert_array_equal(pt["async_poll"].view(np.int32),
                                      pt["sync_dp"].view(np.int32))


# ------------------------------------------------------- the train level
@pytest.mark.parametrize("case", list(CASES))
def test_pod_step_matches_jax(results, case):
    jx = _load(results, f"jax_{case}")
    want_comp = {"a-hier-none": ["pod", "data"], "b-powersgd-pod": ["pod"],
                 "c-signsgd-all": ["pod", "data"], "d-rtob": ["pod"]}[case]
    runs = ["overlap"] + (["classic"] if case == "a-hier-none" else [])
    for schedule in runs:
        for r, pt in enumerate(_ports(results, f"{case}_{schedule}")):
            assert list(pt["compress_axes"]) == list(jx["compress_axes"]) \
                == want_comp
            assert list(pt["raw_axes"]) == list(jx["raw_axes"])
            assert list(pt["dp_axes"]) == ["pod", "data"]
            assert str(pt["schedule"]) == str(jx["schedule"]) == {
                "c-signsgd-all": "serial", "d-rtob": "raw"}.get(case,
                                                               "overlap")
            for s in range(STEPS):
                assert pt[f"tokens/{s}"] == GLOBAL_BATCH * SEQ
                np.testing.assert_allclose(pt[f"loss/{s}"], jx[f"loss/{s}"],
                                           rtol=1e-3, err_msg=f"loss {s}")
                np.testing.assert_allclose(pt[f"grad_norm/{s}"],
                                           jx[f"grad_norm/{s}"], rtol=1e-2)
            # the classic step's shards follow its byte-based buckets
            _assert_state_matches(pt, jx, r, f"{case} {schedule}",
                                  signs=case == "c-signsgd-all",
                                  shards=schedule != "classic")


@pytest.mark.parametrize("case", list(CASES))
def test_pod_serial_and_overlap_give_the_same_bits(results, case):
    """Every rank: parameters, ZeRO-1 shards, compressor states and
    metrics bit for bit, and the parameters the same on all four ranks."""
    ov = _ports(results, f"{case}_overlap")
    se = _ports(results, f"{case}_serial")
    for a, b in zip(ov, se):
        bits = [k for k in a.files if k.startswith("bits/")]
        assert bits == [k for k in b.files if k.startswith("bits/")]
        assert any(k.startswith("bits/agg/") for k in bits) == (
            case in ("b-powersgd-pod", "c-signsgd-all"))
        for k in bits:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in (k for k in bits if k.startswith("bits/param/")):
            np.testing.assert_array_equal(a[k], ov[0][k], err_msg=k)


# -------------------------------------------------------------- local SGD
def test_local_sgd_matches_jax_trainer(results):
    jx = _load(results, "jax_sync")
    for r, pt in enumerate(_ports(results, "sync")):
        assert list(pt["synced"]) == [False, True, False, True]
        _assert_state_matches(pt, jx, r, "local SGD", steps=SYNC_STEPS)


def test_local_sgd_leaves_equal_pods_as_they_were(results):
    """After each sync the pods hold the same bits; the sync changed none
    of them, in the port and in JAX, because the step had already
    averaged the gradient over pod (and ZeRO-1's master, which the sync
    does not touch, is one shard per rank)."""
    assert list(_load(results, "jax_sync")["kept"]) == [True, True]
    for pt in _ports(results, "sync"):
        assert list(pt["agree"]) == [True, True]
        assert list(pt["kept"]) == [True, True]


def test_local_sgd_sync_is_none_without_a_pod_axis():
    """One pod (the default mesh): nothing to average."""
    import torch.distributed as dist

    from repro_torch.configs import base as tcfgs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import train_step as tts
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{mesh_mod.free_port()}",
        rank=0, world_size=1)
    try:
        setup = tts.build(_reduced(tcfgs), "cpu", zero1=False)
        assert setup.dp_axes == ("data",)
        assert mesh_mod.axis_sizes() == {"pod": 1, "data": 1}
        assert tts.local_sgd_sync(setup) is None
        with pytest.raises(ValueError, match="no pod axis"):
            mesh_mod.group(("pod",))
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------- refusals
def test_build_refuses_a_hierarchical_plan_with_an_empty_intra_stage(
        results):
    assert str(_load(results, "jax_refusal")["error"]) == "CommPlanError"
    for pt in _ports(results, "refusal"):
        assert str(pt["error"]) == "CommPlanError"


@pytest.mark.parametrize("multi_pod", [False, True], ids=["one-pod",
                                                          "multi-pod"])
@pytest.mark.parametrize("compress_axes", ["pod", "all"])
@pytest.mark.parametrize("compressor", ["none", "powersgd", "signsgd",
                                        "qsgd", "ef:qsgd"])
def test_from_plan_gives_jax_axes(compressor, compress_axes, multi_pod):
    from repro.configs import base as jcfgs
    from repro.core import aggregator as jagg
    from repro_torch.configs import base as tcfgs
    from repro_torch.core import aggregator as tagg

    def axes(cfgs, agg):
        plan = dataclasses.replace(_reduced(cfgs).plan,
                                   compression=compressor,
                                   compress_axes=compress_axes)
        cfg = agg.from_plan(plan, multi_pod=multi_pod)
        return tuple(cfg.compress_axes), tuple(cfg.raw_axes)
    got = axes(tcfgs, tagg)
    assert got == axes(jcfgs, jagg)
    if not multi_pod:     # one pod: a raw mean for none, else over data
        assert got == (((), ("data",)) if compressor == "none"
                       and compress_axes == "pod" else (("data",), ()))


# ------------------------------------------------------- the entry points
def _jax_worker_keys():
    """The keys of the JAX pod worker's record, read from its source."""
    src = open(os.path.join(ROOT, "src", "repro", "train",
                            "pod_worker.py")).read()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "rec":
            return {kw.arg for kw in node.value.keywords}
    raise AssertionError("no rec = dict(...) in the JAX pod worker")


def test_pod_worker_prints_one_record_with_the_jax_keys(cli):
    out = cli("worker").strip().splitlines()
    assert len(out) == 1                # the other ranks keep stdout silent
    rec = json.loads(out[0])
    keys = _jax_worker_keys()
    assert {"t_serial_us", "t_overlap_us", "t_compute_us", "grad_bytes",
            "fig2_saving_pct", "mesh_shape"} <= keys <= set(rec)
    assert rec["mesh_shape"] == [2, 2] and rec["workers"] == 4
    assert rec["compress_axes"] == ["pod"] and rec["raw_axes"] == ["data"]
    assert rec["device"] == "cpu" and rec["effective_schedule"] == "overlap"
    assert rec["backends"] == {"pod": "gloo", "data": "gloo",
                               "world": "gloo"}
    assert rec["params_identical"] and rec["serial_equals_overlap"]
    assert rec["plan_check"]["hierarchical_close"]
    assert rec["steps_timed"] == 4 and rec["launches"] == {}
    assert all(np.isfinite(rec["losses"]["overlap"]))


def test_launcher_runs_the_pod_mesh(cli):
    out = cli("launcher")
    assert "mesh={'pod': 2, 'data': 2}" in out
    assert "agg=powersgd@('pod',) raw@('data',)" in out
    assert "schedule=overlap" in out and "done at step 2" in out
    assert "step 2: parameters averaged over pod; the same bits on every " \
        "pod: True" in out


# ------------------------------------------------------------ data, flags
def test_pipeline_gives_each_host_its_rows_of_the_global_batch():
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.data.synthetic import DataConfig, batch_at
    cfg = DataConfig(vocab=97, seq_len=8, global_batch=8, seed=3)
    pipes = [Pipeline(cfg, host=h, num_hosts=4, prefetch=p)
             for h, p in ((0, 0), (1, 2), (2, 0), (3, 2))]
    try:
        for step in range(3):
            want = batch_at(cfg, step)
            for h, pipe in enumerate(pipes):
                got = next(pipe)
                for k in ("tokens", "labels"):
                    np.testing.assert_array_equal(got[k].numpy(),
                                                  want[k][2 * h:2 * h + 2])
        pipes[1].seek(1)
        assert pipes[1].cursor() == 1
        np.testing.assert_array_equal(next(pipes[1])["tokens"].numpy(),
                                      batch_at(cfg, 1)["tokens"][2:4])
        assert pipes[1].cursor() == 2
    finally:
        for pipe in pipes:
            pipe.close()
    with pytest.raises(ValueError, match="split"):
        next(Pipeline(cfg, host=0, num_hosts=3, prefetch=0))


@pytest.mark.parametrize("text", ["8", "-3", "0.01", "1e-3", "true", "False",
                                  "powersgd", "", "nan"])
def test_coerce_kv_matches_jax(text):
    from repro.experiments.backend import coerce_kv as jkv
    from repro_torch.experiments.backend import coerce_kv as tkv
    got, want = tkv(text), jkv(text)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)


# ----------------------------------------------------- the build's lock
_STUB = """\
#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(f"start {{os.getppid()}} {{time.time()}} {{'-shared' in sys.argv}}\\n")
time.sleep(0.3)
open(out, "w").close()
with open({log!r}, "a") as f:
    f.write(f"end {{os.getppid()}} {{time.time()}}\\n")
"""

_CALLER = """\
import sys, time
from pathlib import Path
from repro_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
build._nvcc = lambda: sys.argv[2]
path = build.build()
print(path.name, time.time())
"""


def test_two_processes_build_once_in_turn(tmp_path):
    """Two processes reach ``build()`` together; the lock lets one run the
    (stub) compiler on every source and link, and the other, which waits
    for it, finds the library and builds nothing."""
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(_STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    out_dir = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_CALLER), str(out_dir),
         str(stub)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    names = {out.split()[0] for out, _ in outs}
    done = [float(out.split()[1]) for out, _ in outs]
    events = [line.split() for line in log.read_text().splitlines()]
    from repro_torch.kernels import build
    n_src = len(build._sources())
    starts = [e for e in events if e[0] == "start"]
    assert len(starts) == n_src + 1               # each source, one link
    assert len({e[1] for e in events}) == 1       # all from one process
    link_end = max(float(e[2]) for e in events if e[0] == "end")
    assert len(names) == 1 and min(done) >= link_end
    assert (out_dir / names.pop()).exists()


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
