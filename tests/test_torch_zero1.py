"""ZeRO-1, ``reduce_to_owner_broadcast`` and classic accumulation: the port
against the JAX package.

* The owner plan: the port's ``owner_plan`` equals JAX's field for field,
  warnings included, over a sweep of bucket-size lists and rank counts.
* Four ranks: the JAX classic step (``make_step``, ``overlap=False``) on 4
  fake CPU devices in one subprocess, the port on 4 gloo processes, all
  started together; each runs every case below in turn.  The model is the
  reduced ``tinyllama-1.1b`` (vocab 512, 426,624 parameters) with the
  arch's ``zero1=True``; both sides start from the same bf16 parameters
  (drawn here with numpy) and PowerSGD warm starts (drawn here with JAX,
  as the JAX ``init_state`` draws them), take the same per-rank batches,
  3 steps at lr 1e-3.
* Port-internal, on the same gloo ranks: ZeRO-1 against the replicated
  AdamW with ``param_dtype="bfloat16"`` (bit-identical after step 1, as
  ``tests/dist/dist_zero1_accum.py`` holds the JAX package), and
  ``reduce_to_owner_broadcast`` against ZeRO-1 with ``comm="auto"``.
* ``build``'s rules, ``convert``'s ZeRO-1 shards and bf16 parameters, and
  ``Model``'s default device.

The compute dtype.  The cases run the model's matmuls in fp32 on both
sides (``ShardCtx.compute_dtype``; parameters, gradients, buckets,
masters and collectives keep every dtype and rounding point of the arch),
so what they compare is what this slice adds.  In bf16 each package's
gradients differ from its own fp32 ones by 1.0-1.6% (relative L2, every
leaf, JAX and port alike) and from each other's by 0.9-1.4%; m and v,
sums of those gradients, then differ by 2-4%, beyond the 1e-2 their
comparison allows.  One more case, ``a-none-bf16``, runs the arch's bf16
compute and is held to every tolerance but that one.

Tolerances (bf16 parameters and gradients; gloo's and XLA's collectives
round in different orders): loss ``rtol=1e-3``; grad norm ``rtol=1e-2``;
bf16 parameters (in fp32) and each rank's fp32 master shard as in
``tests/test_torch_train.py``: max difference at most
``2 * lr * steps + 1e-4``, at most 2% of elements beyond ``lr / 2``,
median at most ``lr / 50``; each rank's m and v within a relative L2
difference of 1e-2; ``t`` equal.  SignSGD's m is a sum of ±1 votes, and a
vote flips where the ranks' signs tie or a near-zero gradient's sign
differs in the last fp32 bit: one flipped element moves m's relative L2
difference by 2/sqrt(n) (0.55% here), so there at most ``VOTE_SHARE`` of
m's elements may differ (measured: 7 and 15 of 131,072).

``reduce_to_owner_broadcast`` against ZeRO-1 with ``comm="auto"``: loss
``rtol=2e-2``; parameters ``rtol=2e-2, atol=2e-3`` (the JAX oracle's,
``tests/dist/dist_commplan_equivalence.py``) after step 1, and the
AdamW rule above after step 3.  The two sum the ranks' bf16 gradients in
different precisions (gloo's bf16 all-reduce against an fp32
reduce-scatter), and where the ranks' gradients of an element nearly
cancel, the two sums can differ in sign: AdamW then moves the element by
+lr in one run and -lr in the other (2 of 65,536 elements of
``embed.table`` at step 2 here; the JAX package's own two runs differ
by as much on this data).

This file is also the subprocess script: ``python test_torch_zero1.py jax
DIR`` or ``python test_torch_zero1.py torch DIR RANK PORT``.
"""
import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
LR = 1e-3
STEPS = 3
GLOBAL_BATCH = 8
SEQ = 32
TIMEOUT_S = 240
VOTE_SHARE = 1e-3

#: case -> (plan overrides, accum, compute dtype); the arch's zero1=True
CASES = {
    "a-none": (dict(compression="none", bucket_mb=0.125), 1,
               "float32"),                                  # 7 buckets
    "b-none-split": (dict(compression="none", bucket_mb=1), 1,
                     "float32"),                 # 1 bucket, 4 owners
    "c-powersgd": (dict(compression="powersgd", bucket_mb=0.125), 1,
                   "float32"),
    "d-signsgd": (dict(compression="signsgd", bucket_mb=0.125), 1,
                  "float32"),
    "e-rtob": (dict(compression="none", bucket_mb=0.125,
                    comm="reduce_to_owner_broadcast"), 1, "float32"),
    "f-accum2": (dict(compression="none", bucket_mb=0.125), 2, "float32"),
    "a-none-bf16": (dict(compression="none", bucket_mb=0.125), 1,
                    "bfloat16"),
}
#: port-only runs
REPLICATED = (dict(compression="none", bucket_mb=0.125, zero1=False,
                   param_dtype="bfloat16"), 1, "float32")


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
    """in.npz: the start parameters (bf16 values held in fp32, under
    ``param/<name>``), the batches (``tokens/<step>``, ``labels/<step>``)
    and the PowerSGD warm starts (``q/<bucket>``)."""
    import jax

    from repro.configs import base as jcfgs
    from repro.core.compression import base as jbase
    from repro.data.synthetic import DataConfig, batch_at
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_layout
    rng = np.random.default_rng(15)
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
    # PowerSGD's warm starts, as the JAX init_state draws them
    plan = dataclasses.replace(_reduced(jcfgs).plan,
                               **CASES["c-powersgd"][0])
    comp = jbase.make(plan.compression, **jbase.plan_kwargs(plan))
    sizes = _bf16_sizes(cfg, plan.bucket_mb)
    keys = jax.random.split(jax.random.fold_in(jax.random.key(0), 7),
                            len(sizes))
    for i, n in enumerate(sizes):
        arrays[f"q/{i}"] = np.asarray(comp.init_state(n, keys[i]).q)
    np.savez(os.path.join(d, "in.npz"), **arrays)


def _bf16_sizes(cfg, bucket_mb):
    """The bucket sizes of the bf16 gradient of ``cfg``."""
    import torch

    from repro_torch.core import bucketing
    from repro_torch.models.model import param_layout
    leaves = [torch.empty(s, dtype=torch.bfloat16, device="meta")
              for _, s, _ in param_layout(cfg)]
    return bucketing.layout_for(leaves, bucket_mb).sizes


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
    """Every case on a 4-device data mesh; writes jax_<case>.npz."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    from repro.parallel.compat import make_mesh
    from repro.train import train_step as jts
    assert len(jax.devices()) == RANKS
    inp = np.load(os.path.join(d, "in.npz"))
    start = _start_params(inp)
    mesh = make_mesh((RANKS, 1), ("data", "model"))
    for case, (overrides, accum, compute) in CASES.items():
        setup = jts.build(_reduced(jcfgs), mesh, **overrides)
        assert setup.zero1 and not setup.overlap
        setup.ctx = dataclasses.replace(setup.ctx,
                                        compute_dtype=jnp.dtype(compute))
        state = jts.init_state(setup, jax.random.key(0))

        def put(path, x):
            name = ".".join(str(k.key) for k in path)
            return jax.device_put(jnp.asarray(start[name], x.dtype),
                                  x.sharding)
        state["params"] = jax.tree_util.tree_map_with_path(
            put, state["params"])
        state = jts._fill_zero1_master(setup, state,
                                       jts._bucket_layout(setup))
        if overrides["compression"] == "powersgd":
            for i, st in enumerate(state["agg"]):
                np.testing.assert_array_equal(np.asarray(st.q)[0],
                                              inp[f"q/{i}"])
        step = jts.make_step(setup, accum=accum)(_batch(inp, 0))
        out = {}
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
        out["t"] = np.asarray(host["opt"]["t"])
        for k in ("master", "m", "v"):
            out[f"shard/{k}"] = np.asarray(host["opt"]["shard"][k])
        np.savez(os.path.join(d, f"jax_{case}.npz"), **out)
        print(f"jax {case} done", flush=True)


# ------------------------------------------------------------ port side
def _run_port_case(inp, rank, overrides, accum, compute, keep_first=False):
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.train import train_step as tts
    setup = tts.build(_reduced(tcfgs), "cpu", **overrides)
    setup.model.ctx = dataclasses.replace(
        setup.model.ctx, compute_dtype=getattr(torch, compute))
    state = tts.init_state(setup)
    convert.load_params(setup.model, _nest(_start_params(inp)))
    if setup.zero1:
        state = tts._fill_zero1_master(setup, state)
    if overrides["compression"] == "powersgd":
        comp = setup.agg_cfg.build()
        state["agg"] = convert.agg_states(
            comp, [{"q": inp[f"q/{i}"], "err": np.zeros(n, np.float32)}
                   for i, n in enumerate(setup.layout.sizes)], index=None)
    step = tts.make_step(setup, accum=accum)
    out = {}
    for s in range(STEPS):
        state, m = step(state, _batch(inp, s, rank), LR)
        out[f"loss/{s}"] = m["loss"].item()
        out[f"grad_norm/{s}"] = m["grad_norm"].item()
        out[f"tokens/{s}"] = m["tokens"].item()
        if s == 0 and keep_first:
            for name, p in setup.model.named_parameters():
                out[f"first/{name}"] = p.detach().float().numpy().copy()
    for name, p in setup.model.named_parameters():
        assert p.dtype == torch.bfloat16, (name, p.dtype)
        out[f"param/{name}"] = p.detach().float().numpy()
    out["n_buckets"] = setup.layout.n_buckets
    if setup.zero1:
        out["t"] = state["opt"]["t"]
        for k, v in state["opt"]["shard"].items():
            out[f"shard/{k}"] = v.numpy()
    return out


def _run_torch(d, rank, port):
    """One gloo rank: every case, then the replicated bf16 run; writes
    torch_<case>_<rank>.npz."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        inp = np.load(os.path.join(d, "in.npz"))
        runs = dict(CASES, replicated=REPLICATED)
        for case, (overrides, accum, compute) in runs.items():
            out = _run_port_case(inp, rank, overrides, accum, compute,
                                 keep_first=case in ("a-none", "e-rtob",
                                                     "replicated"))
            np.savez(os.path.join(d, f"torch_{case}_{rank}.npz"), **out)
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
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("zero1"))
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


def _assert_close_to_lr(got, want, what):
    """The rule of tests/test_torch_train.py for values that AdamW moved
    ``STEPS`` times by about ``LR``."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * STEPS + 1e-4, (what, diff.max())
    assert (diff > LR / 2).mean() <= 0.02, (what, (diff > LR / 2).mean())
    assert np.median(diff) <= LR / 50, (what, np.median(diff))


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("case", list(CASES))
def test_zero1_step_matches_jax_on_four_ranks(results, case):
    compute = CASES[case][2]
    jx = _load(results, f"jax_{case}")
    ports = [_load(results, f"torch_{case}_{r}") for r in range(RANKS)]
    want_buckets = {"b-none-split": 1}.get(case, 7)
    for r, pt in enumerate(ports):
        assert int(pt["n_buckets"]) == want_buckets
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
            # every rank holds the same parameters
            np.testing.assert_array_equal(pt[k], ports[0][k])
        assert int(pt["t"]) == int(jx["t"]) == STEPS
        assert pt["shard/master"].shape == jx["shard/master"].shape[1:]
        _assert_close_to_lr(pt["shard/master"], jx["shard/master"][r],
                            f"master rank {r}")
        for k in ("m", "v"):
            got, want = pt[f"shard/{k}"], jx[f"shard/{k}"][r]
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            if (case, k) == ("d-signsgd", "m"):
                flipped = np.abs(got - want) > 1e-3 * np.abs(want).max()
                assert flipped.mean() <= VOTE_SHARE, (r, flipped.sum())
            elif compute == "float32":
                assert rel <= 1e-2, (k, r, rel)


def test_zero1_bit_identical_to_replicated_bf16_at_step_1(results):
    """The owner-sharded flat AdamW and the replicated AdamW run the same
    fp32 arithmetic from the same bf16 parameters: the same bits after
    step 1; later steps differ only by the master's fp32 carry."""
    for r in range(RANKS):
        z = _load(results, f"torch_a-none_{r}")
        rep = _load(results, f"torch_replicated_{r}")
        firsts = [k for k in z.files if k.startswith("first/")]
        assert len(firsts) == 12
        for k in firsts:
            np.testing.assert_array_equal(z[k], rep[k], err_msg=k)
        np.testing.assert_allclose([z[f"loss/{s}"] for s in range(STEPS)],
                                   [rep[f"loss/{s}"] for s in range(STEPS)],
                                   rtol=2e-2)


def test_rtob_agrees_with_zero1(results):
    for r in range(RANKS):
        z = _load(results, f"torch_a-none_{r}")
        e = _load(results, f"torch_e-rtob_{r}")
        np.testing.assert_allclose([e[f"loss/{s}"] for s in range(STEPS)],
                                   [z[f"loss/{s}"] for s in range(STEPS)],
                                   rtol=2e-2)
        firsts = [k for k in z.files if k.startswith("first/")]
        assert len(firsts) == 12
        for k in firsts:
            np.testing.assert_allclose(e[k], z[k], rtol=2e-2, atol=2e-3,
                                       err_msg=k)
        for k in (k for k in z.files if k.startswith("param/")):
            _assert_close_to_lr(e[k], z[k], f"{k} rank {r}")


def test_flat_adamw_chunks_give_the_same_bits(monkeypatch):
    """The flat update runs in chunks of ``FLAT_CHUNK`` elements; elementwise
    arithmetic gives the same bits whatever the chunking, and the same bits
    as the replicated update of the same values."""
    import torch

    from repro_torch.train import optimizer as opt_mod
    cfg = opt_mod.OptConfig()
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(1003, generator=gen).to(torch.bfloat16)
    g = torch.randn(1003, generator=gen).to(torch.bfloat16).float()
    outs = []
    for chunk in (2**26, 100, 7):
        monkeypatch.setattr(opt_mod, "FLAT_CHUNK", chunk)
        p, st = p0.float(), opt_mod.flat_adamw_init(1003, "cpu")
        opt_mod.flat_adamw_update(p, g, st, 1, LR, cfg)
        outs.append((p, st["m"], st["v"]))
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    rep = [p0.clone()]
    adamw = opt_mod.AdamW(dataclasses.replace(cfg, grad_clip=0.0))
    adamw.update([g], adamw.init(rep), rep, LR)
    assert torch.equal(rep[0].view(torch.int16),
                       outs[0][0].to(torch.bfloat16).view(torch.int16))


# -------------------------------------------------------------- owner plan
#: bucket-size lists: equal, ragged, one bucket, zero-size buckets, fewer
#: buckets than most rank counts, too few elements for 4+ ranks, and one
#: bucket far larger than the rest (imbalanced beyond 2x n/p)
SIZES = {"equal": (100,) * 8, "ragged": (100, 37, 250, 1, 80, 7),
         "one": (1000,), "zero-size": (50, 0, 70, 0, 30),
         "few": (300, 5), "tiny": (2, 1), "imbalanced": (1000, 10, 10, 10)}


def _plan_and_warnings(mod, sizes, n_ranks):
    layout = mod.BucketLayout(sum(sizes), max(sizes), len(sizes), None,
                              tuple(sizes))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan = mod.owner_plan(layout, n_ranks)
    return plan, [str(w.message) for w in caught]


@pytest.mark.parametrize("n_ranks", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("sizes", list(SIZES))
def test_owner_plan_matches_jax(sizes, n_ranks):
    from repro.core import bucketing as jb
    from repro_torch.core import bucketing as tb
    sizes = SIZES[sizes]
    want, want_warn = _plan_and_warnings(jb, sizes, n_ranks)
    got, got_warn = _plan_and_warnings(tb, sizes, n_ranks)
    for field in ("n_ranks", "owners", "starts", "lengths",
                  "bucket_offsets", "pieces", "cap"):
        assert getattr(got, field) == getattr(want, field), field
    assert got_warn == want_warn
    assert tb.split_for_coverage(sizes, n_ranks) == \
        jb.split_for_coverage(sizes, n_ranks)
    assert tb.assign_owner_ranks(sizes, n_ranks) == \
        jb.assign_owner_ranks(sizes, n_ranks)


def test_owner_plan_warnings_fire():
    from repro_torch.core import bucketing as tb
    _, warn = _plan_and_warnings(tb, SIZES["tiny"], 4)
    assert len(warn) == 1 and "degenerate" in warn[0]
    _, warn = _plan_and_warnings(tb, SIZES["imbalanced"], 4)
    assert len(warn) == 1 and "imbalanced" in warn[0]


# ------------------------------------------------------ build and convert
@pytest.fixture(scope="module")
def world():
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{mesh_mod.free_port()}",
        rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_build_runs_the_arch_as_configured(world):
    """No overrides: ZeRO-1, bf16 parameters and buckets, one fp32 master
    shard holding the parameters' values; the step runs."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.train import train_step as tts
    setup = tts.build(_reduced(tcfgs), "cpu")
    assert setup.zero1 and not setup.rtob
    assert setup.layout.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in setup.model.parameters())
    state = tts.init_state(setup)
    shard = state["opt"]["shard"]
    assert state["opt"]["t"] == 0 and set(shard) == {"master", "m", "v"}
    flat = torch.cat([p.detach().reshape(-1).float()
                      for p in setup.model.parameters()])
    assert shard["master"].dtype == torch.float32
    assert torch.equal(shard["master"], flat)        # p = 1: cap = n
    batch = {k: np.zeros((2, 16), np.int32) for k in ("tokens", "labels")}
    state, m = tts.make_step(setup, accum=2)(state, batch, LR)
    assert state["opt"]["t"] == 1 and np.isfinite(m["loss"].item())
    with pytest.raises(ValueError, match="microbatches"):
        tts.make_step(setup, accum=3)(state, batch, LR)


@pytest.mark.parametrize("overrides", [
    dict(zero1=False, comm="reduce_to_owner_broadcast"),
    dict(zero1=True, compression="powersgd",
         comm="reduce_to_owner_broadcast"),
], ids=["without-zero1", "compressed"])
def test_rtob_needs_zero1_and_no_compressor(world, overrides):
    from repro_torch.configs import base as tcfgs
    from repro_torch.parallel import commplan as cp
    from repro_torch.train import train_step as tts
    with pytest.raises(cp.CommPlanError):
        tts.build(_reduced(tcfgs), "cpu", **overrides)


def test_opt_state_takes_this_ranks_row():
    import torch

    from repro_torch import convert
    rng = np.random.default_rng(0)
    shard = {k: rng.standard_normal((RANKS, 5)).astype(np.float32)
             for k in ("master", "m", "v")}
    for r in range(RANKS):
        got = convert.opt_state({"t": np.int32(3), "shard": shard}, r)
        assert got["t"] == 3
        for k, v in got["shard"].items():
            assert v.dtype == torch.float32 and v.shape == (5,)
            np.testing.assert_array_equal(v.numpy(), shard[k][r])


def test_load_params_keeps_every_bf16_bit():
    """Random 16-bit patterns (NaNs and infinities included) as
    ``ml_dtypes.bfloat16`` arrays land in bf16 parameters unchanged."""
    import jax.numpy as jnp
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model, param_layout
    cfg = _reduced(tcfgs)
    model = Model(cfg, ShardCtx(param_dtype=torch.bfloat16), device="cpu")
    rng = np.random.default_rng(1)
    flat = {name: rng.integers(0, 2**16, shape, dtype=np.uint16)
            .view(jnp.bfloat16) for name, shape, _ in param_layout(cfg)}
    convert.load_params(model, _nest(flat))
    n_nan = 0
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        bits = p.detach().view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(bits, flat[name].view(np.uint16))
        n_nan += int(torch.isnan(p).sum())
    assert n_nan > 0                         # NaN payloads were in play


def test_model_default_device_is_the_card():
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import Model
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only behaviour does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(_reduced(tcfgs))
    assert next(Model(_reduced(tcfgs), device="meta").parameters()) \
        .device.type == "meta"


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
