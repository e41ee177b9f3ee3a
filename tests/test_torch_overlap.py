"""The overlapped DDP step (``repro_torch.train.overlap``): the port against
the JAX package (``repro.train.overlap``).

* Leaf-aligned layouts: ``leaf_aligned_sizes`` and
  ``layout_from_leaf_sizes`` equal JAX's field for field over a sweep that
  holds a zero-size trailing leaf, a leaf bigger than the target and a
  single leaf; the leaf-aligned buckets round-trip exactly.
* ``build_layout`` equals JAX's on the reduced ``tinyllama-1.1b`` and on the
  full-size arch (built on ``meta``: 46 bf16 buckets, 90 fp32 ones), with
  ``bucket_ready`` and ``stage_leaf_range``; ``effective_schedule`` equals
  JAX's for every compressor and comm plan.
* Four ranks: JAX ``make_step`` with ``overlap=True`` on 4 fake CPU devices
  in one subprocess, the port on 4 gloo processes, all started together;
  each runs every case below in turn, 3 steps of the reduced model at lr
  1e-3 from the same bf16 parameters (drawn here with numpy), the same
  per-rank batches and the compressor state JAX's ``init_state`` draws
  (PowerSGD's warm starts loaded into the port; RandomK's indices, from
  JAX's keys, put in place of the port's draw function).
* Port-internal, on the same ranks: ``serial`` and ``overlap`` give the
  same bits on every rank (parameters, ZeRO-1 shards, compressor states,
  metrics), as ``tests/dist/dist_overlap_equivalence.py`` and
  ``dist_zero1_accum.py`` hold the JAX package; the unfused step agrees
  with ``serial`` (loss ``rtol=1e-4``), and the segmented step with the
  port's classic step (loss ``rtol=1e-3``: other bucket boundaries and,
  under accumulation, ``(g + sum) / accum`` rounded once where the classic
  step divides the sum).
* Under ``accum > 1`` each bucket is aggregated once per step; ``build``
  takes ``overlap=True`` for the dense family and refuses FSDP and the
  families the port does not have (``tests/test_torch_moe_step.py``
  holds the MoE family's overlapped step); ``--overlap`` on the CPU
  launcher and ``overlap_bench`` run.

The cases compute in fp32 on both sides with the arch's bf16 parameters
(RandomK runs ``zero1=False``, the classic fp32 parameters), for the
reason ``tests/test_torch_zero1.py`` gives.  Tolerances are that file's:
loss ``rtol=1e-3``; grad norm ``rtol=1e-2``; parameters and each rank's
fp32 master shard: max difference at most ``2 * lr * steps + 1e-4``, at
most 2% of elements beyond ``lr / 2``, median at most ``lr / 50``; each
rank's m and v within a relative L2 difference of 1e-2, except SignSGD's
m, where at most ``VOTE_SHARE`` of the elements may differ (a vote flips
where the ranks' signs tie); ``t`` equal.

This file is also the subprocess script: ``python test_torch_overlap.py jax
DIR`` or ``python test_torch_overlap.py torch DIR RANK PORT``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
LR = 1e-3
STEPS = 3
GLOBAL_BATCH = 24            # 6 rows per rank: 2 or 3 microbatches
SEQ = 32
BUCKET_MB = 0.125            # 6 bf16 buckets, 10 fp32 ones
TIMEOUT_S = 300
VOTE_SHARE = 1e-3

#: case -> (plan overrides, accum); the arch's zero1=True unless overridden
CASES = {
    "a-none": (dict(compression="none"), 1),
    "b-powersgd": (dict(compression="powersgd"), 1),
    "c-signsgd": (dict(compression="signsgd"), 1),        # runs serial
    "d-randomk": (dict(compression="randomk", zero1=False), 1),
    "e-rtob": (dict(compression="none",
                    comm="reduce_to_owner_broadcast"), 1),  # runs raw
    "f-accum2": (dict(compression="none"), 2),
    "g-accum3": (dict(compression="none"), 3),
}
#: the port's runs of each case: overlapped, serial and, where they exist,
#: the unfused strawman and the classic (not segmented) step
UNFUSED = [c for c, (_, accum) in CASES.items() if accum == 1]
CLASSIC = ["a-none", "f-accum2", "g-accum3"]


def _reduced(cfgs):
    return cfgs.reduced(cfgs.get("tinyllama-1.1b"))


def _plan(cfgs, case):
    return dataclasses.replace(_reduced(cfgs).plan, bucket_mb=BUCKET_MB,
                               overlap=True, **CASES[case][0])


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


def _port_layout(param_dtype):
    """The port's overlap layout of the reduced model (no allocation)."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import overlap
    model = Model(_reduced(tcfgs), ShardCtx(param_dtype=param_dtype),
                  device="meta")
    return overlap.layout_for_model(model, BUCKET_MB).layout


# ------------------------------------------------------------ the inputs
def _make_inputs(d):
    """in.npz: the start parameters (bf16 values held in fp32), the batches,
    PowerSGD's warm starts (``q/<bucket>``) and RandomK's keys
    (``rk_key/<bucket>``) as JAX's ``init_state`` draws them, and RandomK's
    indices of every step (``rk/<step>/<bucket>``) from those keys."""
    import jax
    import torch

    from repro.configs import base as jcfgs
    from repro.core.compression import base as jbase
    from repro.data.synthetic import DataConfig, batch_at
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_layout
    rng = np.random.default_rng(16)
    arrays = {}
    cfg = _reduced(tcfgs)
    for name, shape, std in param_layout(cfg):
        a = np.ones(shape) if std is None else std * np.clip(
            rng.standard_normal(shape), -3, 3)
        arrays[f"param/{name}"] = np.asarray(
            jax.numpy.asarray(a, jax.numpy.bfloat16), np.float32)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=GLOBAL_BATCH)
    for s in range(STEPS):
        for k, v in batch_at(dcfg, s).items():
            arrays[f"{k}/{s}"] = v

    def keys(n):
        return jax.random.split(jax.random.fold_in(jax.random.key(0), 7), n)
    plan = _plan(jcfgs, "b-powersgd")
    comp = jbase.make(plan.compression, **jbase.plan_kwargs(plan))
    sizes = _port_layout(torch.bfloat16).sizes
    for i, (n, k) in enumerate(zip(sizes, keys(len(sizes)))):
        arrays[f"q/{i}"] = np.asarray(comp.init_state(n, k).q)
    plan = _plan(jcfgs, "d-randomk")
    comp = jbase.make(plan.compression, **jbase.plan_kwargs(plan))
    sizes = _port_layout(torch.float32).sizes
    for i, (n, k) in enumerate(zip(sizes, keys(len(sizes)))):
        arrays[f"rk_key/{i}"] = np.asarray(jax.random.key_data(k))
        for s in range(STEPS):
            k, sub = jax.random.split(k)
            arrays[f"rk/{s}/{i}"] = np.asarray(
                jax.random.permutation(sub, n)[:comp.k_for(n)])
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
def _run_jax(d):
    """Every case's overlapped step on a 4-device data mesh; writes
    jax_<case>.npz."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    from repro.parallel.compat import make_mesh
    from repro.train import overlap as jov
    from repro.train import train_step as jts
    assert len(jax.devices()) == RANKS
    inp = np.load(os.path.join(d, "in.npz"))
    start = _start_params(inp)
    mesh = make_mesh((RANKS, 1), ("data", "model"))
    for case, (overrides, accum) in CASES.items():
        setup = jts.build(_reduced(jcfgs), mesh, bucket_mb=BUCKET_MB,
                          overlap=True, **overrides)
        assert setup.overlap
        setup.ctx = dataclasses.replace(setup.ctx,
                                        compute_dtype=jnp.float32)
        state = jts.init_state(setup, jax.random.key(0))

        def put(path, x):
            name = ".".join(str(k.key) for k in path)
            return jax.device_put(jnp.asarray(start[name], x.dtype),
                                  x.sharding)
        state["params"] = jax.tree_util.tree_map_with_path(
            put, state["params"])
        out = {"schedule": jov.effective_schedule(setup)}
        if setup.zero1:
            state = jts._fill_zero1_master(setup, state,
                                           jts._bucket_layout(setup))
            out["init_master"] = np.asarray(
                jax.device_get(state["opt"]["shard"]["master"]))
        for i, st in enumerate(state["agg"]):
            if case == "b-powersgd":
                np.testing.assert_array_equal(np.asarray(st.q)[0],
                                              inp[f"q/{i}"])
            if case == "d-randomk":
                np.testing.assert_array_equal(
                    np.asarray(jax.random.key_data(st.key))[0],
                    inp[f"rk_key/{i}"])
        step = jts.make_step(setup, accum=accum)(_batch(inp, 0))
        for s in range(STEPS):
            state, m = step(state, _batch(inp, s), jnp.float32(LR))
            m = jax.device_get(m)
            out[f"loss/{s}"], out[f"grad_norm/{s}"] = m["loss"], \
                m["grad_norm"]
        host = jax.device_get(state)
        for path, x in jax.tree_util.tree_flatten_with_path(
                host["params"])[0]:
            name = ".".join(str(k.key) for k in path)
            out[f"param/{name}"] = np.asarray(x, np.float32)
        if setup.zero1:
            out["t"] = np.asarray(host["opt"]["t"])
            for k in ("master", "m", "v"):
                out[f"shard/{k}"] = np.asarray(host["opt"]["shard"][k])
        np.savez(os.path.join(d, f"jax_{case}.npz"), **out)
        print(f"jax {case} done", flush=True)


# ------------------------------------------------------------ port side
def _bits(t):
    """A tensor's raw bits as a numpy array (bf16 as int16, fp32 as
    int32), so equal arrays mean the same bits."""
    import torch
    t = t.detach().cpu().contiguous()
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(
        t.dtype)
    return (t.view(view) if view else t).numpy()


def _state_tensors(state):
    """(dotted field, tensor) of a compressor state (nested NamedTuples)."""
    out = []
    for name, v in zip(state._fields, state):
        if isinstance(v, tuple):
            out += [(f"{name}.{k}", t) for k, t in _state_tensors(v)]
        else:
            out.append((name, v))
    return out


def _install_randomk_draws(inp, state):
    """Put JAX's indices in place of the port's RandomK draw: the port's
    key of bucket b at step s (its initial key advanced s times by
    ``split_key``, as ``decode`` advances it) selects JAX's draw of that
    bucket and step."""
    import torch

    from repro_torch.core.compression import randomk
    from repro_torch.core.compression.base import split_key
    table = {}
    for b, st in enumerate(state["agg"]):
        key = st.key
        for s in range(STEPS):
            table[tuple(key.tolist())] = inp[f"rk/{s}/{b}"]
            key, _ = split_key(key)

    def indices(key, n, k, device):
        draw = table[tuple(key.tolist())]
        assert draw.shape == (k,)
        return torch.from_numpy(draw.astype(np.int64)).to(device)
    randomk.indices = indices


def _run_port_case(inp, rank, case, schedule):
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.train import overlap
    from repro_torch.train import train_step as tts
    overrides, accum = CASES[case]
    setup = tts.build(_reduced(tcfgs), "cpu", bucket_mb=BUCKET_MB,
                      overlap=schedule != "classic", **overrides)
    setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                          compute_dtype=torch.float32)
    state = tts.init_state(setup)
    convert.load_params(setup.model, _nest(_start_params(inp)))
    out = {}
    if setup.zero1:
        state = tts._fill_zero1_master(setup, state)
        out["init_master"] = state["opt"]["shard"]["master"].numpy().copy()
    if case == "b-powersgd":
        comp = setup.agg_cfg.build()
        state["agg"] = convert.agg_states(
            comp, [{"q": inp[f"q/{i}"], "err": np.zeros(n, np.float32)}
                   for i, n in enumerate(setup.layout.sizes)], index=None)
    if case == "d-randomk":
        _install_randomk_draws(inp, state)
    if schedule == "serial":
        step = overlap.make_step(setup, "serial", accum)
    elif schedule == "unfused":
        step = overlap.make_unfused_step(setup)
    else:
        step = tts.make_step(setup, accum)
    out["schedule"] = overlap.effective_schedule(setup)
    for s in range(STEPS):
        state, m = step(state, _batch(inp, s, rank), LR)
        for k in ("loss", "grad_norm", "tokens"):
            out[f"{k}/{s}"] = m[k].item()
            out[f"bits/{k}/{s}"] = _bits(m[k])
        out[f"order/{s}"] = np.asarray(getattr(step, "flush_order", []),
                                       np.int64).reshape(-1, 2)
    for name, p in setup.model.named_parameters():
        out[f"param/{name}"] = p.detach().float().numpy()
        out[f"bits/param/{name}"] = _bits(p)
    if setup.zero1:
        out["t"] = state["opt"]["t"]
        for k, v in state["opt"]["shard"].items():
            out[f"shard/{k}"] = v.numpy()
            out[f"bits/shard/{k}"] = _bits(v)
    for b, st in enumerate(state["agg"]):
        for field, t in _state_tensors(st):
            out[f"bits/agg/{b}/{field}"] = _bits(t)
    out["n_buckets"] = setup.layout.n_buckets
    out["bucket_ready"] = np.asarray(
        overlap.build_layout(setup).bucket_ready if setup.overlap else [])
    return out


def _runs():
    """(case, schedule) of every port run."""
    runs = [(c, s) for c in CASES for s in ("overlap", "serial")]
    runs += [(c, "unfused") for c in UNFUSED]
    runs += [(c, "classic") for c in CLASSIC]
    return runs


def _run_torch(d, rank, port):
    """One gloo rank: every run; writes torch_<case>_<schedule>_<rank>.npz."""
    import torch.distributed as dist

    from repro_torch.core.compression import randomk
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    draw = randomk.indices
    try:
        inp = np.load(os.path.join(d, "in.npz"))
        for case, schedule in _runs():
            out = _run_port_case(inp, rank, case, schedule)
            randomk.indices = draw
            np.savez(os.path.join(d, f"torch_{case}_{schedule}_{rank}.npz"),
                     **out)
    finally:
        dist.destroy_process_group()


def _env(**extra):
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


#: the entry points' CPU runs: ``python -m <module> <args>``
CLI_RUNS = {
    "launcher": ("repro_torch.launch.train", "--device", "cpu", "--overlap",
                 "--steps", "2", "--batch", "4", "--seq", "32",
                 "--log-every", "1"),
    "bench": ("repro_torch.train.overlap_bench", "--device", "cpu",
              "--zero1", "--batch", "4", "--seq", "32", "--reps", "2",
              "--warmup", "1", "--bucket-mb", "0.125"),
}


@pytest.fixture(scope="module")
def cli():
    """Starts every run of ``CLI_RUNS`` at once; ``cli(name)`` waits for
    one and returns its standard output."""
    procs = {k: subprocess.Popen([sys.executable, "-m", *args],
                                 env=_env(OMP_NUM_THREADS="1"), cwd=ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, args in CLI_RUNS.items()}
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
    """Runs every case on both sides (the entry points' runs of ``cli``
    start first and run beside them)."""
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("overlap"))
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


def _ports(d, case, schedule):
    return [_load(d, f"torch_{case}_{schedule}_{r}") for r in range(RANKS)]


def _assert_close_to_lr(got, want, what):
    """The rule of tests/test_torch_train.py for values that AdamW moved
    ``STEPS`` times by about ``LR``."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * STEPS + 1e-4, (what, diff.max())
    assert (diff > LR / 2).mean() <= 0.02, (what, (diff > LR / 2).mean())
    assert np.median(diff) <= LR / 50, (what, np.median(diff))


# ------------------------------------------------- four ranks against JAX
@pytest.mark.parametrize("case", list(CASES))
def test_overlap_step_matches_jax_on_four_ranks(results, case):
    jx = _load(results, f"jax_{case}")
    ports = _ports(results, case, "overlap")
    want_sched = {"c-signsgd": "serial", "e-rtob": "raw"}.get(case,
                                                              "overlap")
    for r, pt in enumerate(ports):
        assert str(pt["schedule"]) == str(jx["schedule"]) == want_sched
        assert int(pt["n_buckets"]) == (10 if case == "d-randomk" else 6)
        for s in range(STEPS):
            assert pt[f"tokens/{s}"] == GLOBAL_BATCH * SEQ
            np.testing.assert_allclose(pt[f"loss/{s}"], jx[f"loss/{s}"],
                                       rtol=1e-3, err_msg=f"loss {s}")
            np.testing.assert_allclose(pt[f"grad_norm/{s}"],
                                       jx[f"grad_norm/{s}"], rtol=1e-2,
                                       err_msg=f"grad norm {s}")
        names = [k for k in jx.files if k.startswith("param/")]
        assert sorted(names) == sorted(k for k in pt.files
                                       if k.startswith("param/"))
        for k in names:
            _assert_close_to_lr(pt[k], jx[k], f"{k} rank {r}")
            np.testing.assert_array_equal(pt[k], ports[0][k])
        if "t" not in jx.files:
            continue
        assert int(pt["t"]) == int(jx["t"]) == STEPS
        assert pt["shard/master"].shape == jx["shard/master"].shape[1:]
        _assert_close_to_lr(pt["shard/master"], jx["shard/master"][r],
                            f"master rank {r}")
        for k in ("m", "v"):
            got, want = pt[f"shard/{k}"], jx[f"shard/{k}"][r]
            if (case, k) == ("c-signsgd", "m"):
                flipped = np.abs(got - want) > 1e-3 * np.abs(want).max()
                assert flipped.mean() <= VOTE_SHARE, (r, flipped.sum())
            else:
                rel = np.linalg.norm(got - want) / max(
                    np.linalg.norm(want), 1e-30)
                assert rel <= 1e-2, (k, r, rel)


def test_jax_overlap_zero1_shards_load_into_the_port(results):
    """Under the same leaf-aligned layout JAX's ZeRO-1 master shards are
    already in the port's order: each rank's row is the port's shard, bit
    for bit, and ``convert.opt_state`` takes it over as it is."""
    from repro_torch import convert
    for case in ("a-none", "b-powersgd", "e-rtob"):
        jx = _load(results, f"jax_{case}")
        for r, pt in enumerate(_ports(results, case, "overlap")):
            np.testing.assert_array_equal(pt["init_master"],
                                          jx["init_master"][r])
        shard = {k: jx[f"shard/{k}"] for k in ("master", "m", "v")}
        got = convert.opt_state({"t": jx["t"], "shard": shard}, 2)
        np.testing.assert_array_equal(got["shard"]["m"].numpy(),
                                      shard["m"][2])


# ------------------------------------------------------ port-internal
@pytest.mark.parametrize("case", list(CASES))
def test_serial_and_overlap_give_the_same_bits(results, case):
    """Every rank: parameters, ZeRO-1 shards, compressor states and
    metrics bit for bit; the flush order is ``bucket_ready`` under
    ``overlap`` and after the last stage under ``serial``."""
    ov, se = _ports(results, case, "overlap"), _ports(results, case,
                                                      "serial")
    for a, b in zip(ov, se):
        bits = [k for k in a.files if k.startswith("bits/")]
        assert bits == [k for k in b.files if k.startswith("bits/")]
        assert any(k.startswith("bits/shard/") for k in bits) == (
            case != "d-randomk")
        assert any(k.startswith("bits/agg/") for k in bits) == (
            case in ("b-powersgd", "c-signsgd", "d-randomk"))
        for k in bits:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        ready = list(a["bucket_ready"])
        last = max(ready)
        sched = str(a["schedule"])
        for s in range(STEPS):
            want_ov = [(bk, r) for bk, r in enumerate(ready)] \
                if sched == "overlap" else (
                    [] if sched == "raw" else [(bk, last) for bk in
                                               range(len(ready))])
            want_se = [] if sched == "raw" else [(bk, last) for bk in
                                                 range(len(ready))]
            assert [tuple(x) for x in a[f"order/{s}"]] == want_ov
            assert [tuple(x) for x in b[f"order/{s}"]] == want_se


@pytest.mark.parametrize("case", UNFUSED)
def test_unfused_agrees_with_serial(results, case):
    for a, b in zip(_ports(results, case, "unfused"),
                    _ports(results, case, "serial")):
        np.testing.assert_allclose([a[f"loss/{s}"] for s in range(STEPS)],
                                   [b[f"loss/{s}"] for s in range(STEPS)],
                                   rtol=1e-4)


@pytest.mark.parametrize("case", CLASSIC)
def test_segmented_agrees_with_classic(results, case):
    for a, b in zip(_ports(results, case, "overlap"),
                    _ports(results, case, "classic")):
        assert int(b["n_buckets"]) == 7         # byte-based boundaries
        np.testing.assert_allclose([a[f"loss/{s}"] for s in range(STEPS)],
                                   [b[f"loss/{s}"] for s in range(STEPS)],
                                   rtol=1e-3)


# -------------------------------------------------------- layouts (CPU)
#: (leaf sizes, bucket elements): zero-size trailing leaves, a leaf bigger
#: than the target, a single leaf, exact fits and empty leaves inside
LEAF_SWEEP = [([5, 0], 5), ([10, 5000, 10], 256), ([7], 3), ([7], 100),
              ([0], 1), ([3, 0, 0], 2), ([100] * 8, 250), ([1, 2, 3, 4, 5], 4),
              ([4, 4, 4, 4], 4), ([0, 0, 6, 0], 3), ([300, 10, 7, 2000, 1], 64)]


@pytest.mark.parametrize("sizes,target", LEAF_SWEEP,
                         ids=[f"{len(s)}-leaves-{t}" for s, t in LEAF_SWEEP])
def test_leaf_aligned_layouts_match_jax(sizes, target):
    import jax.numpy as jnp
    import torch

    from repro.core import bucketing as jb
    from repro_torch.core import bucketing as tb
    assert tb.leaf_aligned_sizes(sizes, target) == \
        jb.leaf_aligned_sizes(sizes, target)
    mb = target * 4 / 2**20
    want = jb.layout_from_leaf_sizes(sizes, jnp.float32, mb)
    got = tb.layout_from_leaf_sizes(sizes, torch.float32, mb)
    for field in ("n_elements", "bucket_elems", "n_buckets", "sizes",
                  "leaf_sizes", "leaf_bucket", "leaf_aligned", "last_elems"):
        assert getattr(got, field) == getattr(want, field), field
    for b in range(got.n_buckets):
        assert got.bucket_leaves(b) == want.bucket_leaves(b)
    # the buckets and their inverse, against JAX's on the same values
    rng = np.random.default_rng(len(sizes) * target)
    leaves = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    got_b = tb.to_buckets([torch.from_numpy(x) for x in leaves], got)
    want_b = jb.leaves_to_buckets([jnp.asarray(x) for x in leaves], want)
    assert len(got_b) == len(want_b) == got.n_buckets
    for g, w in zip(got_b, want_b):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = tb.from_buckets(got_b, [torch.from_numpy(x) for x in leaves], got)
    for x, y in zip(back, leaves):
        np.testing.assert_array_equal(x.numpy(), y)


def test_leaf_aligned_buckets_keep_dtypes():
    """bf16 buckets of mixed leaves: each leaf comes back in its dtype."""
    import torch

    from repro_torch.core import bucketing as tb
    leaves = [torch.randn(6, 5).to(torch.bfloat16), torch.randn(3),
              torch.randn(40).to(torch.bfloat16)]
    layout = tb.layout_for(leaves, 10 * 2 / 2**20, leaf_aligned=True)
    assert layout.dtype == torch.bfloat16 and layout.leaf_aligned
    assert layout.sizes == (30, 43) and layout.leaf_bucket == (0, 1, 1)
    back = tb.from_buckets(tb.to_buckets(leaves, layout), leaves, layout)
    for x, y in zip(back, leaves):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y.to(torch.bfloat16).to(y.dtype))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("zero1", [True, False], ids=["bf16", "fp32"])
def test_build_layout_matches_jax(full, zero1):
    """JAX's ``overlap.build_layout`` against the port's on a model with the
    same leaves: the reduced arch at ``BUCKET_MB`` and the full-size one at
    the arch's 25 MB (46 bf16 buckets under ZeRO-1, 90 fp32 without)."""
    import torch

    from repro.configs import base as jcfgs
    from repro.launch.mesh import make_local_mesh
    from repro.train import overlap as jov
    from repro.train import train_step as jts
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import overlap as tov
    bucket_mb = 25 if full else BUCKET_MB
    jarch = jcfgs.get("tinyllama-1.1b")
    tarch = tcfgs.get("tinyllama-1.1b")
    if not full:
        jarch, tarch = jcfgs.reduced(jarch), tcfgs.reduced(tarch)
    want = jov.build_layout(jts.build(jarch, make_local_mesh(),
                                      bucket_mb=bucket_mb, zero1=zero1,
                                      overlap=True))
    dtype = torch.bfloat16 if zero1 else torch.float32
    got = tov.layout_for_model(Model(tarch, ShardCtx(param_dtype=dtype),
                                     device="meta"), bucket_mb)
    assert str(got.layout.dtype).removeprefix("torch.") == \
        str(want.layout.dtype)
    for field in ("n_elements", "bucket_elems", "n_buckets", "sizes",
                  "leaf_sizes", "leaf_bucket"):
        assert getattr(got.layout, field) == getattr(want.layout, field)
    assert (got.n_stages, got.bucket_ready) == (want.n_stages,
                                                want.bucket_ready)
    assert [dataclasses.astuple(s) for s in got.stacks] == \
        [dataclasses.astuple(s) for s in want.stacks]
    for s in range(got.n_stages + 1):
        assert got.stage_leaf_range(s) == want.stage_leaf_range(s)
        assert got.buckets_ready_at(s) == want.buckets_ready_at(s)
    if full:
        assert got.layout.n_buckets == (46 if zero1 else 90)
        assert got.n_stages == 22 and got.bucket_ready[-1] == 22


COMPRESSORS = ("none", "powersgd", "signsgd", "qsgd", "terngrad", "randomk",
               "mstopk", "ef:qsgd")
COMMS = ("auto", "allreduce", "reduce_scatter_allgather", "gather_all",
         "reduce_to_owner_broadcast")


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_effective_schedule_matches_jax(compressor, comm):
    """The schedule each (compressor, comm plan) runs under
    ``overlap=True`` over a data axis, or the same error class for an
    illegal pair, in both packages."""
    import types

    from repro.configs import base as jcfgs
    from repro.core import aggregator as jagg
    from repro.train import overlap as jov
    from repro_torch.configs import base as tcfgs
    from repro_torch.core import aggregator as tagg
    from repro_torch.train import overlap as tov

    def resolve(cfgs, agg, ov, **kw):
        plan = dataclasses.replace(_reduced(cfgs).plan, overlap=True,
                                   compression=compressor, comm=comm)
        try:
            agg_cfg = agg.from_plan(plan, **kw)
        except ValueError as e:
            return type(e).__name__
        rtob = (plan.zero1 and compressor == "none"
                and agg_cfg.comm.kind == "reduce_to_owner_broadcast")
        try:
            return ov.effective_schedule(types.SimpleNamespace(
                rtob=rtob, agg_cfg=agg_cfg))
        except ValueError as e:
            return type(e).__name__
    want = resolve(jcfgs, jagg, jov, multi_pod=False)
    assert resolve(tcfgs, tagg, tov) == want
    if compressor in ("signsgd", "qsgd", "terngrad", "mstopk", "ef:qsgd") \
            and comm == "auto":
        assert want == "serial"


# ------------------------------------------------------ one rank (CPU)
@pytest.fixture(scope="module")
def world():
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{mesh_mod.free_port()}",
        rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("accum", [2, 3])
def test_accum_flushes_each_bucket_once(world, monkeypatch, accum):
    """``accum > 1`` aggregates each bucket once per step, on the final
    microbatch, in ``bucket_ready`` order."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.core import aggregator as agg_mod
    from repro_torch.train import train_step as tts
    setup = tts.build(_reduced(tcfgs), "cpu", bucket_mb=BUCKET_MB,
                      overlap=True)
    # one rank drops the data axis; point it back so the flushes run
    setup.agg_cfg = dataclasses.replace(setup.agg_cfg, raw_axes=("data",))
    calls = []
    orig = agg_mod.GradAggregator.aggregate_one
    orig_start = agg_mod.GradAggregator.start_one

    def counting(self, bucket, st):
        calls.append(bucket.numel())
        return orig(self, bucket, st)

    def counting_start(self, bucket):
        # the uncompressed flush issues its mean asynchronously
        calls.append(bucket.numel())
        return orig_start(self, bucket)

    monkeypatch.setattr(agg_mod.GradAggregator, "aggregate_one", counting)
    monkeypatch.setattr(agg_mod.GradAggregator, "start_one", counting_start)
    state = tts.init_state(setup)
    step = tts.make_step(setup, accum=accum)
    batch = {k: np.ones((6, 16), np.int64) for k in ("tokens", "labels")}
    for _ in range(2):
        calls.clear()
        state, m = step(state, batch, LR)
        assert tuple(calls) == setup.layout.sizes
        assert step.flush_order == list(enumerate(
            tts.overlap_mod.build_layout(setup).bucket_ready))
        assert np.isfinite(m["loss"].item())
    assert all(p.dtype == torch.bfloat16 for p in setup.model.parameters())


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_segmented_backward_gives_the_classic_gradients(world, tied, remat):
    """One graph per stage, taken in reverse layer order, gives the bits of
    the classic step's one-graph backward (fp32 compute, one rank), with
    and without recompute, and with the embedding tied to the
    unembedding (its gradient is the sum of both uses)."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.train import overlap
    from repro_torch.train import train_step as tts
    arch = dataclasses.replace(_reduced(tcfgs), tie_embeddings=tied)
    setup = tts.build(arch, "cpu", overlap=True, zero1=False,
                      bucket_mb=BUCKET_MB, remat=remat)
    setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                          compute_dtype=torch.float32)
    setup.model.init_params(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, arch.vocab, (2, 16)))
             for k in ("tokens", "labels")}
    ov = overlap.build_layout(setup)
    flush = overlap._Flush(ov, None, (), "raw", False)
    leaves, loss_sum, n_glob, moe_aux = overlap._segmented_backward(
        setup, ov, batch, flush, 8)
    assert moe_aux.item() == 0.0
    got = overlap._unordered_tree(ov, leaves)
    params = list(setup.model.parameters())
    want_loss, ntok, _ = setup.model.loss(batch, 8)
    want = torch.autograd.grad(want_loss * (1 / ntok.float()), params)
    assert int(n_glob) == int(ntok) == 32
    assert torch.equal(loss_sum, want_loss.detach())
    assert len(got) == len(want) == len(params) == (11 if tied else 12)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_build_runs_the_overlapped_step(world):
    """``build(..., overlap=True)``: the leaf-aligned layout keys the
    compressor states and the ZeRO-1 shard; FSDP and families the port
    does not have are refused."""
    from repro_torch.configs import base as tcfgs
    from repro_torch.train import overlap
    from repro_torch.train import train_step as tts
    arch = _reduced(tcfgs)
    setup = tts.build(arch, "cpu", overlap=True, bucket_mb=BUCKET_MB,
                      compression="powersgd")
    assert setup.overlap and setup.zero1 and setup.layout.leaf_aligned
    assert setup.layout is overlap.build_layout(setup).layout
    state = tts.init_state(setup)
    assert state["opt"]["shard"]["master"].shape == \
        (setup.layout.n_elements,)
    with pytest.raises(ValueError, match="FSDP"):
        overlap.check_supported(arch, dataclasses.replace(
            arch.plan, dp_mode="fsdp"))
    # every family the port builds is supported (the vlm family since
    # its slice); a family with no block stack is refused as in JAX
    overlap.check_supported(dataclasses.replace(arch, family="vlm"),
                            arch.plan)
    with pytest.raises(ValueError, match="no scanned block stack"):
        overlap.check_supported(dataclasses.replace(arch, family="unknown"),
                                arch.plan)
    assert overlap.supports(arch, arch.plan) == (True, "")
    with pytest.raises(ValueError, match="schedule"):
        overlap.make_step(setup, "unfused")


def test_ordered_leaves_round_trip():
    """``_ordered_leaves`` gives per-layer views, last layer first, then the
    tail; ``_unordered_tree`` stacks them back."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import overlap
    model = Model(_reduced(tcfgs), ShardCtx(), device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    ov = overlap.layout_for_model(model, BUCKET_MB)
    params = list(model.parameters())
    ordered = overlap._ordered_leaves(ov, params)
    assert [t.numel() for t in ordered] == list(ov.layout.leaf_sizes)
    assert ordered[0].data_ptr() == params[0][-1].data_ptr()
    back = overlap._unordered_tree(ov, ordered)
    for x, y in zip(back, params):
        assert torch.equal(x, y)


# ------------------------------------------------ launch plans (CPU)
#: the overlap layout's PowerSGD matrices and element-wise bucket sizes
OVERLAP_MATRICES = [(4552, 4608), (4743, 4864), (8000, 8192), (8001, 8192),
                    (2902, 3072), (3338, 3456), (3366, 3584)]
OVERLAP_NS = [20_975_616, 23_068_672, 65_536_000, 65_538_048]


@pytest.mark.parametrize("rows,cols", OVERLAP_MATRICES)
def test_powersgd_plans_at_the_overlap_shapes(rows, cols):
    """Every split of every PowerSGD launch is non-empty and the splits
    cover the reduction once; every element and byte offset a kernel
    forms fits its integer type."""
    from repro_torch.kernels import powersgd as kp
    assert rows * cols * 4 < 2**31                # byte offsets of M
    for n_a, n_b, strides in ((rows, cols, (cols, 1)),
                              (cols, rows, (1, cols))):
        plan = kp.encode_plan((n_a, n_b), strides, 0, 4, 132)
        assert 1 <= plan.splits <= 65535 and plan.tiles <= 2**31 - 1
        assert (plan.splits - 1) * plan.per < n_b <= plan.splits * plan.per
        assert plan.splits * n_a * 4 < 2**31       # split partials
    plan = kp.decode_plan(rows, cols, 4, 132)
    assert (plan.splits - 1) * plan.per < rows <= plan.splits * plan.per
    assert plan.vec == 4


@pytest.mark.parametrize("n", OVERLAP_NS)
def test_elementwise_plans_at_the_overlap_sizes(n):
    from repro_torch.kernels import bitpack as kb
    words = -(-n // 32)
    for p in (1, 4, 16, 512):
        plan = kb.votes_plan(p, words, n, 132)
        assert plan.groups * kb.GROUP_ELEMS >= n
        assert plan.groups * kb.GROUP_ELEMS < 2**32   # unsigned offsets
        assert p * words < 2**31
    assert 4 * n < 2**31


# ------------------------------------------------------ entry points
def test_launcher_runs_the_overlapped_step_on_the_cpu(cli):
    out = cli("launcher")
    assert "overlap=True" in out and "done at step 2" in out


def test_overlap_bench_times_three_schedules_on_the_cpu(cli):
    rec = json.loads(cli("bench").strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["n_buckets"] == 6
    assert set(rec["step_ms"]) == {"overlap", "serial", "unfused"}
    assert rec["effective_schedule"] == "overlap"


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
