"""The MoE family's DDP step: the port (``repro_torch.train``) against the
JAX package's on four ranks, and the entry points on the MoE arch.

* Four ranks: JAX ``make_step`` on 4 fake CPU devices in one subprocess,
  the port on 4 gloo processes, all started together; each runs every
  case below, 3 steps of the reduced ``qwen2-moe-a2.7b`` (2 layers, 4
  experts top-2, one shared expert) on ``dp_mode="ddp"`` at lr 1e-3 from
  the same parameters (drawn here with numpy; bf16 values, the router and
  the shared gate fp32 under ZeRO-1), the same per-rank batches and the
  PowerSGD warm starts JAX's ``init_state`` draws: the classic fp32 step
  with ``none`` and with PowerSGD, ZeRO-1 with ``none`` (the two fp32
  leaves ride the bf16 buckets and the fp32 master), and the overlapped
  ZeRO-1 step with PowerSGD.  The port runs that last case under
  ``overlap`` and ``serial``, which must give the same bits on every rank
  (parameters, ZeRO-1 shards, compressor states, metrics).
* ``--arch qwen2-moe-a2.7b --overlap --device cpu`` on the launcher: it
  says that it forces ``dp_mode="ddp"`` and trains.
* ``resolve_plan`` on the full-size ``qwen2-moe-a2.7b`` with
  ``dp_mode="ddp"`` equals JAX's, float for float (n_dev 2, batch 4 x
  512: PowerSGD, predicted 18.674 against 45.854 for overlapped syncSGD).

The cases compute in fp32 on both sides, for the reason
``tests/test_torch_zero1.py`` gives.  Tolerances are that file's: loss
and ``moe_aux`` ``rtol=1e-3``; grad norm ``rtol=1e-2``; parameters and
each rank's fp32 master shard: max difference at most ``2 * lr * steps +
1e-4``, at most 2% of elements beyond ``lr / 2``, median at most ``lr /
50``; each rank's m and v within a relative L2 difference of 1e-2; ``t``
equal.  ``moe_aux`` is each rank's own (JAX reports device 0's), so it is
compared on rank 0.

Routing is discontinuous.  Under ZeRO-1 the gradients are bf16 and their
mean over the ranks rounds in each package's own order (0.3% of m after
one step); from the parameters that follow, a token whose two best
experts nearly tie can pick the other one in one package.  Each step's
routing is therefore recomputed here, from both packages' parameters
before the step (``_routing``): where no pick or capacity drop differs
the rule above holds; where some do (at most ``MAX_FLIPS`` per step), m
and v are held to a relative L2 difference of ``FLIP_RTOL`` and the rest
to the rule above.

This file is also the subprocess script: ``python test_torch_moe_step.py
jax DIR`` or ``python test_torch_moe_step.py torch DIR RANK PORT``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(ROOT)
ARCH = "qwen2-moe-a2.7b"
RANKS = 4
LR = 1e-3
STEPS = 3
GLOBAL_BATCH = 8             # 2 rows per rank
SEQ = 16
BUCKET_MB = 0.125
TIMEOUT_S = 300
#: at most this many (token, pick) routings may differ per step, and then
#: m and v are held to FLIP_RTOL
MAX_FLIPS = 2
FLIP_RTOL = 5e-2

#: case -> plan overrides beside dp_mode="ddp"
CASES = {
    "a-classic-none": dict(zero1=False),
    "b-classic-powersgd": dict(zero1=False, compression="powersgd"),
    "c-zero1-none": dict(zero1=True),
    "d-overlap-powersgd": dict(zero1=True, overlap=True,
                               compression="powersgd"),
}
#: the port's runs: (case, schedule)
RUNS = [(c, "classic") for c in CASES if "overlap" not in CASES[c]] \
    + [("d-overlap-powersgd", "overlap"), ("d-overlap-powersgd", "serial")]


def _reduced(cfgs):
    return cfgs.reduced(cfgs.get(ARCH))


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _port_sizes(case):
    """Bucket sizes of the port's layout for a case (no allocation)."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.core import bucketing
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import overlap
    ov = CASES[case]
    model = Model(_reduced(tcfgs), ShardCtx(
        param_dtype=torch.bfloat16 if ov["zero1"] else torch.float32),
        device="meta")
    if ov.get("overlap"):
        return overlap.layout_for_model(model, BUCKET_MB).layout.sizes
    return bucketing.layout_for(list(model.parameters()), BUCKET_MB).sizes


# ------------------------------------------------------------ the inputs
def _make_inputs(d):
    """in.npz: the start parameters (bf16 values for the bf16 leaves, held
    in fp32), the batches and, per PowerSGD case, the warm starts
    (``q/<case>/<bucket>``) JAX's ``init_state`` draws."""
    import jax
    import torch

    from repro.configs import base as jcfgs
    from repro.core.compression import base as jbase
    from repro.data.synthetic import DataConfig, batch_at
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import leaf_dtype, param_layout
    rng = np.random.default_rng(20)
    arrays = {}
    cfg = _reduced(tcfgs)
    bf16 = ShardCtx(param_dtype=torch.bfloat16)
    for name, shape, std in param_layout(cfg):
        a = np.ones(shape) if std is None else std * np.clip(
            rng.standard_normal(shape), -3, 3)
        dt = jax.numpy.float32 if leaf_dtype(name, bf16) == torch.float32 \
            else jax.numpy.bfloat16
        arrays[f"param/{name}"] = np.asarray(jax.numpy.asarray(a, dt),
                                             np.float32)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=GLOBAL_BATCH)
    for s in range(STEPS):
        for k, v in batch_at(dcfg, s).items():
            arrays[f"{k}/{s}"] = v
    for case, ov in CASES.items():
        if ov.get("compression") != "powersgd":
            continue
        plan = dataclasses.replace(_reduced(jcfgs).plan, **ov)
        comp = jbase.make(plan.compression, **jbase.plan_kwargs(plan))
        sizes = _port_sizes(case)
        keys = jax.random.split(jax.random.fold_in(jax.random.key(0), 7),
                                len(sizes))
        for i, (n, k) in enumerate(zip(sizes, keys)):
            arrays[f"q/{case}/{i}"] = np.asarray(comp.init_state(n, k).q)
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
    for case, ov in CASES.items():
        setup = jts.build(_reduced(jcfgs), mesh, dp_mode="ddp",
                          bucket_mb=BUCKET_MB, **ov)
        setup.ctx = dataclasses.replace(setup.ctx,
                                        compute_dtype=jnp.float32)
        state = jts.init_state(setup, jax.random.key(0))

        def put(path, x):
            name = ".".join(str(k.key) for k in path)
            return jax.device_put(jnp.asarray(start[name], x.dtype),
                                  x.sharding)
        state["params"] = jax.tree_util.tree_map_with_path(
            put, state["params"])
        if setup.zero1:
            state = jts._fill_zero1_master(setup, state,
                                           jts._bucket_layout(setup))
        for i, st in enumerate(state["agg"]):
            np.testing.assert_array_equal(np.asarray(st.q)[0],
                                          inp[f"q/{case}/{i}"])
        out = {}
        step = jts.make_step(setup)(_batch(inp, 0))
        for s in range(STEPS):
            for path, x in jax.tree_util.tree_flatten_with_path(
                    jax.device_get(state["params"]))[0]:
                name = ".".join(str(k.key) for k in path)
                out[f"before/{s}/{name}"] = np.asarray(x, np.float32)
            state, m = step(state, _batch(inp, s), jnp.float32(LR))
            m = jax.device_get(m)
            for k in ("loss", "grad_norm", "moe_aux"):
                out[f"{k}/{s}"] = m[k]
        host = jax.device_get(state)
        for path, x in jax.tree_util.tree_flatten_with_path(
                host["params"])[0]:
            name = ".".join(str(k.key) for k in path)
            out[f"param/{name}"] = np.asarray(x, np.float32)
            out[f"dtype/{name}"] = str(x.dtype)
        if setup.zero1:
            out["t"] = np.asarray(host["opt"]["t"])
            for k in ("master", "m", "v"):
                out[f"shard/{k}"] = np.asarray(host["opt"]["shard"][k])
        np.savez(os.path.join(d, f"jax_{case}.npz"), **out)
        print(f"jax {case} done", flush=True)


# ------------------------------------------------------------ port side
def _bits(t):
    import torch
    t = t.detach().cpu().contiguous()
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(
        t.dtype)
    return (t.view(view) if view else t).numpy()


def _run_port_case(inp, rank, case, schedule):
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.train import overlap
    from repro_torch.train import train_step as tts
    setup = tts.build(_reduced(tcfgs), "cpu", dp_mode="ddp",
                      bucket_mb=BUCKET_MB, **CASES[case])
    setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                          compute_dtype=torch.float32)
    state = tts.init_state(setup)
    convert.load_params(setup.model, _nest(_start_params(inp)))
    if setup.zero1:
        state = tts._fill_zero1_master(setup, state)
    if state["agg"]:
        state["agg"] = convert.agg_states(
            setup.agg_cfg.build(),
            [{"q": inp[f"q/{case}/{i}"], "err": np.zeros(n, np.float32)}
             for i, n in enumerate(setup.layout.sizes)], index=None)
    step = overlap.make_step(setup, schedule) if schedule != "classic" \
        else tts.make_step(setup)
    out = {}
    for s in range(STEPS):
        for name, p in setup.model.named_parameters():
            out[f"before/{s}/{name}"] = p.detach().float().numpy().copy()
        batch = _batch(inp, s, rank)
        for k, v in batch.items():
            out[f"batch/{k}/{s}"] = v
        state, m = step(state, batch, LR)
        for k in ("loss", "grad_norm", "moe_aux", "tokens"):
            out[f"{k}/{s}"] = m[k].item()
            out[f"bits/{k}/{s}"] = _bits(m[k])
    for name, p in setup.model.named_parameters():
        out[f"param/{name}"] = p.detach().float().numpy()
        out[f"dtype/{name}"] = str(p.dtype).removeprefix("torch.")
        out[f"bits/param/{name}"] = _bits(p)
    if setup.zero1:
        out["t"] = state["opt"]["t"]
        for k, v in state["opt"]["shard"].items():
            out[f"shard/{k}"] = v.numpy()
            out[f"bits/shard/{k}"] = _bits(v)
    for b, st in enumerate(state["agg"]):
        for field in ("q", "err"):
            out[f"bits/agg/{b}/{field}"] = _bits(getattr(st, field))
    return out


def _run_torch(d, rank, port):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        inp = np.load(os.path.join(d, "in.npz"))
        for case, schedule in RUNS:
            np.savez(os.path.join(d, f"torch_{case}_{schedule}_{rank}.npz"),
                     **_run_port_case(inp, rank, case, schedule))
    finally:
        dist.destroy_process_group()


def _env(**extra):
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


#: the launcher's CPU run on the reduced MoE arch
LAUNCHER = ("repro_torch.launch.train", "--arch", ARCH, "--device", "cpu",
            "--overlap", "--steps", "2", "--batch", "4", "--seq", "32",
            "--log-every", "1")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Runs every case on both sides and the launcher beside them; returns
    (directory, the launcher's standard output)."""
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("moe_step"))
    launcher = subprocess.Popen([sys.executable, "-m", *LAUNCHER],
                                env=_env(OMP_NUM_THREADS="1"), cwd=ROOT,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        _make_inputs(d)
        me = os.path.abspath(__file__)
        xla = os.environ.get("XLA_FLAGS", "") \
            + f" --xla_force_host_platform_device_count={RANKS}"
        port = str(free_port())
        procs = [subprocess.Popen([sys.executable, me, "jax", d],
                                  env=_env(XLA_FLAGS=xla),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)]
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
        out = launcher.communicate(timeout=TIMEOUT_S)[0]
        assert launcher.returncode == 0, out[-3000:]
    finally:
        launcher.kill()
    return d, out


def _load(d, name):
    return np.load(os.path.join(d, f"{name}.npz"))


def _ports(d, case, schedule):
    return [_load(d, f"torch_{case}_{schedule}_{r}") for r in range(RANKS)]


def _routing(params, batch):
    """Every layer's expert picks and keep mask of ``batch`` from the
    parameters ``params`` ({name: fp32 array}), in fp32 on the port."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import ShardCtx, rmsnorm
    from repro_torch.models.model import BLOCK_PREFIX, Model, positions_of
    cfg = _reduced(tcfgs)
    model = Model(cfg, ShardCtx(compute_dtype=torch.float32), device="cpu")
    out = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(params[name]))
        tokens = torch.from_numpy(batch["tokens"]).long()
        x = model.stage_embed(model.embed.table, tokens)
        pos = positions_of(tokens)
        for layer in range(cfg.n_layers):
            p_l = {n[len(BLOCK_PREFIX):]: t[layer] for n, t in
                   model.named_parameters() if n.startswith(BLOCK_PREFIX)}
            h = x + tf.attn_apply(p_l, rmsnorm(p_l["ln1.scale"], x),
                                  pos, cfg, model.ctx)
            xt = rmsnorm(p_l["ln2.scale"], h).reshape(-1, cfg.d_model)
            _, top_i, _ = moe._route(p_l["moe.router"], xt, cfg.moe,
                                     cfg.moe.n_experts)
            cap = moe.capacity(xt.shape[0], cfg.moe.top_k,
                               cfg.moe.n_experts, 1,
                               cfg.moe.capacity_factor)
            _, _, keep = moe._dispatch_indices(top_i, cfg.moe.n_experts, cap)
            out.append((top_i.numpy(), keep.numpy()))
            x, _ = moe.moe_block_apply(p_l, x, pos, cfg, model.ctx)
    return out


def _flips(jx, pt):
    """Per step: how many (token, pick) expert choices or keep flags of
    one rank's batch differ between the two packages' parameters before
    the step."""
    out = []
    for s in range(STEPS):
        names = [k.split("/", 2)[2] for k in jx.files
                 if k.startswith(f"before/{s}/")]
        batch = {k: pt[f"batch/{k}/{s}"] for k in ("tokens", "labels")}
        a = _routing({n: jx[f"before/{s}/{n}"] for n in names}, batch)
        b = _routing({n: pt[f"before/{s}/{n}"] for n in names}, batch)
        out.append(sum(int((ta != tb).sum() + (ka != kb).sum())
                       for (ta, ka), (tb, kb) in zip(a, b)))
    return out


def _assert_close_to_lr(got, want, what):
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * STEPS + 1e-4, (what, diff.max())
    assert (diff > LR / 2).mean() <= 0.02, (what, (diff > LR / 2).mean())
    assert np.median(diff) <= LR / 50, (what, np.median(diff))


@pytest.mark.parametrize("case", list(CASES))
def test_moe_step_matches_jax_on_four_ranks(results, case):
    d, _ = results
    jx = _load(d, f"jax_{case}")
    schedule = "overlap" if CASES[case].get("overlap") else "classic"
    ports = _ports(d, case, schedule)
    # a flip on any rank moves the mean gradient of every rank
    flips = [sum(f) for f in zip(*(_flips(jx, pt) for pt in ports))] \
        if "t" in jx.files else []
    for r, pt in enumerate(ports):
        for s in range(STEPS):
            assert pt[f"tokens/{s}"] == GLOBAL_BATCH * SEQ
            np.testing.assert_allclose(pt[f"loss/{s}"], jx[f"loss/{s}"],
                                       rtol=1e-3, err_msg=f"loss {s}")
            np.testing.assert_allclose(pt[f"grad_norm/{s}"],
                                       jx[f"grad_norm/{s}"], rtol=1e-2,
                                       err_msg=f"grad norm {s}")
            assert np.isfinite(pt[f"moe_aux/{s}"]) and pt[f"moe_aux/{s}"] > 0
        names = [k for k in jx.files if k.startswith("param/")]
        assert sorted(names) == sorted(k for k in pt.files
                                       if k.startswith("param/"))
        for k in names:
            name = k.split("/", 1)[1]
            assert str(pt[f"dtype/{name}"]) == str(jx[f"dtype/{name}"])
            _assert_close_to_lr(pt[k], jx[k], f"{k} rank {r}")
            np.testing.assert_array_equal(pt[k], ports[0][k])
        if "t" not in jx.files:
            continue
        assert int(pt["t"]) == int(jx["t"]) == STEPS
        _assert_close_to_lr(pt["shard/master"], jx["shard/master"][r],
                            f"master rank {r}")
        assert flips[0] == 0 and max(flips) <= MAX_FLIPS, flips
        for k in ("m", "v"):
            got, want = pt[f"shard/{k}"], jx[f"shard/{k}"][r]
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert rel <= (FLIP_RTOL if any(flips) else 1e-2), \
                (k, r, rel, flips)
    for s in range(STEPS):
        np.testing.assert_allclose(ports[0][f"moe_aux/{s}"],
                                   jx[f"moe_aux/{s}"], rtol=1e-3,
                                   err_msg=f"moe_aux {s}")


def test_moe_zero1_keeps_the_fp32_leaves(results):
    """Under ZeRO-1 the router and the shared gate stay fp32 and come back
    from the bf16 gather as JAX's do."""
    d, _ = results
    for case in ("c-zero1-none", "d-overlap-powersgd"):
        pt = _ports(d, case, "classic" if case.startswith("c") else
                    "overlap")[0]
        fp32 = {k.split("/", 1)[1] for k in pt.files
                if k.startswith("dtype/") and str(pt[k]) == "float32"}
        assert fp32 == {"blocks.moe.router", "blocks.moe.shared_gate"}


def test_serial_and_overlap_give_the_same_bits(results):
    d, _ = results
    ov, se = (_ports(d, "d-overlap-powersgd", s) for s in ("overlap",
                                                            "serial"))
    for a, b in zip(ov, se):
        bits = [k for k in a.files if k.startswith("bits/")]
        assert bits == [k for k in b.files if k.startswith("bits/")]
        assert any(k.startswith("bits/agg/") for k in bits)
        assert any(k.startswith("bits/shard/") for k in bits)
        for k in bits:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_launcher_trains_the_moe_arch_with_overlap(results):
    _, out = results
    assert "--overlap: dp_mode 'fsdp' -> 'ddp'" in out
    assert f"arch={ARCH}-smoke" in out and "overlap=True" in out
    assert "done at step 2" in out and "nan" not in out


def test_resolve_plan_on_the_moe_arch_matches_jax():
    from repro.adaptive import controller as jctl
    from repro.configs import base as jcfgs
    from repro_torch.adaptive import controller as tctl
    from repro_torch.configs import base as tcfgs
    ja, ta = jcfgs.get(ARCH), tcfgs.get(ARCH)
    jp, jd = jctl.resolve_plan(dataclasses.replace(ja.plan, dp_mode="ddp"),
                               ja, 2, batch=4, seq=512)
    tp, td = tctl.resolve_plan(dataclasses.replace(ta.plan, dp_mode="ddp"),
                               ta, 2, batch=4, seq=512)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert (td.scheme, tp.overlap, tp.dp_mode) == ("powersgd", True, "ddp")
    assert (round(td.t_pred, 3), round(td.t_base, 3)) == (18.674, 45.854)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), sys.argv[4])
