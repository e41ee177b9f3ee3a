"""The FSDP/HSDP step (``dp_mode="fsdp"``) of the port against the JAX
package's.

* Four ranks: JAX ``make_step`` on 4 fake CPU devices as a ``(pod 2, data
  2)`` mesh in one subprocess, the port on 4 gloo processes joined by
  ``init_pod_mesh(2, 2)``, all started together.  Each runs every case
  below, ``STEPS`` steps at lr 1e-3 from the same global parameters
  (drawn here with numpy) and the same global batches, computing in fp32:
  the reduced ``qwen2-vl-7b`` as configured (``dp_mode="fsdp"``, AdamW,
  ``remat="full"``) under HSDP (FSDP over ``data``) uncompressed and
  with PowerSGD over ``pod`` on the gradient shards (JAX's warm starts
  injected), under ``fsdp_shard_pods=True`` (FSDP over both axes) and
  under ``gather_quant="int8"``; and the reduced ``qwen2-moe-a2.7b`` as
  configured, which checks the loss scale and ``moe_aux / p_fsdp``.  The
  vlm batches carry ``embeds`` and ``mrope_positions`` with three distinct
  streams.  Compared on global arrays (``convert.global_params``).
* On the same ranks: ``fsdp_gather`` and the int8 gather, forward and
  backward (each rank's cotangent its own, so the reduce-scatter's sum
  shows), over ``data`` (2 ranks) and over ``("pod", "data")`` (4), against
  JAX's ``layers.fsdp_gather`` under ``shard_map``; pod replicas hold the
  same shard bits; a leaf FSDP does not shard drifts apart across
  ``data`` under HSDP PowerSGD, in both packages, and nowhere else; the
  sharded Adafactor update equals the unsharded one on the gathered
  arrays.
* One device: JAX's FSDP step on a one-device mesh drops the size-1 FSDP
  axis and runs unsharded; the port's one-rank FSDP step matches it.
  JAX's microbatch split fails on ``mrope_positions`` at ``accum=2``; the
  port raises ``ValueError`` there.
* The sharded dim of every leaf (``models.model.param_dims``) equals the
  dim of JAX's ``abstract_init`` spec that names the FSDP axis, for every
  reduced arch.

Tolerances (fp32 compute on both sides): loss ``rtol=1e-4``; grad norm
``rtol=1e-3``; ``moe_aux`` ``rtol=1e-4``; parameters: max difference at
most ``2 * lr * steps + 1e-4``, at most 2% of elements beyond ``lr / 2``
(each leaf of at least ``SMALL_LEAF`` elements, the smaller leaves
pooled), median at most ``lr / 50``: Adam's sign-like update moves
near-zero gradients by up to ``lr`` either way; AdamW's m and v within a
relative L2 difference of 1e-2.  The gathers: plain exact, int8 to
1e-6 of the largest entry (the same quantization, dequantized in fp32);
their backward exact over two ranks (one rounding of a sum of two) and to
1e-6 relative over four (the order of the sum differs).
The Adafactor self-check: 1e-6 relative.

This file is also the subprocess script: ``python test_torch_fsdp.py
jax DIR`` or ``python test_torch_fsdp.py torch DIR RANK PORT``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VLM, MOE = "qwen2-vl-7b", "qwen2-moe-a2.7b"
RANKS = 4
LR = 1e-3
STEPS = 2
GLOBAL_BATCH = 8             # 2 rows per rank
SEQ = 24
IMAGE, GRID = 16, 4
BUCKET_MB = 0.0625
TIMEOUT_S = 300
SMALL_LEAF = 2048

#: case -> (arch, plan overrides beside dp_mode="fsdp")
CASES = {
    "a-hsdp-none": (VLM, dict(remat="full")),
    "b-hsdp-powersgd": (VLM, dict(remat="full", compression="powersgd")),
    "c-zero3": (VLM, dict(fsdp_shard_pods=True)),
    "d-int8": (VLM, dict(gather_quant="int8")),
    "e-moe": (MOE, dict()),
}
#: (axes, dim, int8, dtype) of the gather checks
GATHERS = [(("data",), 0, False, "float32"),
           (("data",), 1, False, "bfloat16"),
           (("pod", "data"), 1, False, "float32"),
           (("data",), 0, True, "float32"),
           (("data",), 1, True, "bfloat16"),
           (("pod", "data"), 0, True, "float32")]
GATHER_SHAPE = (8, 12)


def _reduced(cfgs, name):
    cfg = cfgs.reduced(cfgs.get(name))
    return cfgs.reduced(cfgs.get(name), plan=dataclasses.replace(
        cfg.plan, dp_mode="fsdp"))


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _local_sizes(name, ov):
    """Bucket sizes of the port's classic layout over the local shards of
    a rank of the case's FSDP mesh (no allocation)."""
    from repro_torch.configs import base as tcfgs
    from repro_torch.core import bucketing
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    axes = ("pod", "data") if ov.get("fsdp_shard_pods") else ("data",)
    model = Model(_reduced(tcfgs, name), ShardCtx(fsdp_axes=axes),
                  device="meta", fsdp_size=2 * len(axes))
    return bucketing.layout_for(list(model.parameters()), BUCKET_MB).sizes


# ------------------------------------------------------------ the inputs
def _make_inputs(d):
    """in.npz: per arch the start parameters (global, fp32) and the
    global batches; per PowerSGD case the warm starts JAX's
    ``init_state`` draws; the gather checks' weights and cotangents."""
    import jax

    from repro.configs import base as jcfgs
    from repro.core.compression import base as jbase
    from repro.data.synthetic import DataConfig, batch_at
    from repro_torch.configs import base as tcfgs
    from repro_torch.launch.inputs import vlm_positions
    from repro_torch.models.model import param_layout
    rng = np.random.default_rng(29)
    arrays = {}
    for name in (VLM, MOE):
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
            arrays[f"batch/{name}/{s}/labels"] = b["labels"]
            if name == MOE:
                arrays[f"batch/{name}/{s}/tokens"] = b["tokens"]
                continue
            arrays[f"batch/{name}/{s}/embeds"] = rng.standard_normal(
                (GLOBAL_BATCH, SEQ, cfg.d_model)).astype(np.float32)
            arrays[f"batch/{name}/{s}/mrope_positions"] = vlm_positions(
                GLOBAL_BATCH, SEQ, IMAGE, GRID).numpy().astype(np.int32)
    for case, (name, ov) in CASES.items():
        if ov.get("compression") != "powersgd":
            continue
        plan = dataclasses.replace(_reduced(jcfgs, name).plan, **ov)
        comp = jbase.make(plan.compression, **jbase.plan_kwargs(plan))
        sizes = _local_sizes(name, ov)
        keys = jax.random.split(jax.random.fold_in(jax.random.key(0), 7),
                                len(sizes))
        for i, (n, k) in enumerate(zip(sizes, keys)):
            arrays[f"q/{case}/{i}"] = np.asarray(comp.init_state(n, k).q)
    for i, _ in enumerate(GATHERS):
        arrays[f"gw/{i}"] = rng.standard_normal(GATHER_SHAPE).astype(
            np.float32)
        arrays[f"gct/{i}"] = rng.standard_normal(
            (RANKS, *GATHER_SHAPE)).astype(np.float32)
    np.savez(os.path.join(d, "in.npz"), **arrays)


def _start(inp, name):
    pre = f"param/{name}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def _batch(inp, name, step):
    pre = f"batch/{name}/{step}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def _gather_slice(w, axes, dim, coords):
    """The shard of ``w`` a rank at ``coords`` (pod, data) holds."""
    p = {("data",): 2, ("pod", "data"): 4}[axes]
    idx = coords[1] if axes == ("data",) else coords[0] * 2 + coords[1]
    n = w.shape[dim] // p
    return np.take(w, np.arange(idx * n, (idx + 1) * n), axis=dim)


# ------------------------------------------------------------- JAX side
def _jax_state(jts, setup, start):
    import jax
    import jax.numpy as jnp
    setup.ctx = dataclasses.replace(setup.ctx, compute_dtype=jnp.float32)
    state = jts.init_state(setup, jax.random.key(0))

    def put(path, x):
        name = ".".join(str(k.key) for k in path)
        return jax.device_put(jnp.asarray(start[name], x.dtype), x.sharding)
    state["params"] = jax.tree_util.tree_map_with_path(put, state["params"])
    return state


def _jax_steps(jts, setup, state, inp, name, out, accum=1):
    import jax
    import jax.numpy as jnp
    step = jts.make_step(setup, accum=accum)(_batch(inp, name, 0))
    for s in range(STEPS):
        state, m = step(state, _batch(inp, name, s), jnp.float32(LR))
        m = jax.device_get(m)
        for k in ("loss", "grad_norm", "moe_aux"):
            out[f"{k}/{s}"] = np.asarray(m[k])
    host = jax.device_get(state)
    for path, x in jax.tree_util.tree_flatten_with_path(host["params"])[0]:
        out["param/" + ".".join(str(k.key) for k in path)] = \
            np.asarray(x, np.float32)
    for k in ("m", "v"):
        for path, x in jax.tree_util.tree_flatten_with_path(
                host["opt"][k])[0]:
            out[f"{k}/" + ".".join(str(p.key) for p in path)] = \
                np.asarray(x, np.float32)
    return state


def _run_jax(d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.configs import base as jcfgs
    from repro.models import layers as jlayers
    from repro.parallel.compat import make_mesh, shard_map
    from repro.train import train_step as jts
    assert len(jax.devices()) == RANKS
    inp = np.load(os.path.join(d, "in.npz"))

    # ---- the gathers, forward and backward, per device
    mesh2 = make_mesh((2, 2), ("pod", "data"))
    out = {}
    for i, (axes, dim, quant, dtype) in enumerate(GATHERS):
        ctx = jlayers.ShardCtx(fsdp_axes=axes,
                               gather_quant="int8" if quant else None)
        entry = axes if len(axes) > 1 else axes[0]
        wspec = P(entry, None) if dim == 0 else P(None, entry)

        def run(w, ct, ctx=ctx, dim=dim):
            y, vjp = jax.vjp(lambda v: jlayers.fsdp_gather(v, ctx, dim), w)
            (g,) = vjp(ct[0].astype(y.dtype))
            return y[None], g[None]
        f = shard_map(run, mesh2, in_specs=(wspec, P(("pod", "data"))),
                      out_specs=(P(("pod", "data")), P(("pod", "data"))))
        y, g = jax.jit(f)(jnp.asarray(inp[f"gw/{i}"], jnp.dtype(dtype)),
                          jnp.asarray(inp[f"gct/{i}"], jnp.dtype(dtype)))
        out[f"y/{i}"] = np.asarray(y, np.float32)
        out[f"g/{i}"] = np.asarray(g, np.float32)
    np.savez(os.path.join(d, "jax_gathers.npz"), **out)

    # ---- the step cases on pod 2 x data 2
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
    for case, (name, ov) in CASES.items():
        setup = jts.build(_reduced(jcfgs, name), mesh, bucket_mb=BUCKET_MB,
                          **ov)
        state = _jax_state(jts, setup, _start(inp, name))
        for i, st in enumerate(state["agg"]):
            np.testing.assert_array_equal(np.asarray(st.q)[0],
                                          inp[f"q/{case}/{i}"])
        out = {"fsdp_axes": np.asarray(setup.fsdp_axes),
               "compress_axes": np.asarray(setup.agg_cfg.compress_axes)}
        state = _jax_steps(jts, setup, state, inp, name, out)
        # each device's own copy of a leaf FSDP does not shard
        devs = list(mesh.devices.flat)
        for sh in state["params"]["final_norm"]["scale"].addressable_shards:
            out[f"unsharded/{devs.index(sh.device)}"] = np.asarray(sh.data)
        np.savez(os.path.join(d, f"jax_{case}.npz"), **out)
        print(f"jax {case} done", flush=True)

    # ---- one device: the size-1 FSDP axis is dropped; accum=2 fails
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    setup = jts.build(_reduced(jcfgs, VLM), mesh1, bucket_mb=BUCKET_MB)
    out = {"fsdp_axes": np.asarray(setup.fsdp_axes, dtype=str),
           "p_fsdp": np.asarray(setup.p_fsdp)}
    state = _jax_state(jts, setup, _start(inp, VLM))
    _jax_steps(jts, setup, state, inp, VLM, out)
    state = _jax_state(jts, setup, _start(inp, VLM))
    try:
        _jax_steps(jts, setup, state, inp, VLM, {}, accum=2)
        out["accum2_error"] = np.asarray("")
    except Exception as e:  # noqa: BLE001 - the reference's own failure
        out["accum2_error"] = np.asarray(f"{type(e).__name__}: {e}")
    np.savez(os.path.join(d, "jax_one.npz"), **out)


# ------------------------------------------------------------ port side
def _port_setup(tts, convert, name, ov, start):
    import torch
    setup = tts.build(_reduced(_tcfgs(), name), "cpu", bucket_mb=BUCKET_MB,
                      **ov)
    setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                          compute_dtype=torch.float32)
    state = tts.init_state(setup)
    convert.load_params(setup.model, _nest(start))
    return setup, state


def _tcfgs():
    from repro_torch.configs import base as tcfgs
    return tcfgs


def _port_steps(tts, convert, setup, state, inp, name, split):
    """STEPS steps; the metrics, and the global parameters and AdamW
    moments (collectives: every rank calls this)."""
    out = {}
    step = tts.make_step(setup)
    for s in range(STEPS):
        b = _batch(inp, name, s)
        if split:
            b = tts.split_batch(b, RANKS, split[0])
        state, m = step(state, b, LR)
        for k in ("loss", "grad_norm", "moe_aux"):
            out[f"{k}/{s}"] = m[k].item()
    names = [n for n, _ in setup.model.named_parameters()]
    for n, p in convert.global_params(setup.model).items():
        out[f"param/{n}"] = p.float().numpy()
    for k in ("m", "v"):
        for n, t in zip(names, state["opt"][k]):
            out[f"{k}/{n}"] = convert.to_global(setup.model, n, t).numpy()
    return state, out


def _run_port_case(inp, rank, case):
    import torch

    from repro_torch import convert
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import train_step as tts
    name, ov = CASES[case]
    setup, state = _port_setup(tts, convert, name, ov, _start(inp, name))
    if state["agg"]:
        state["agg"] = convert.agg_states(
            setup.agg_cfg.build(),
            [{"q": inp[f"q/{case}/{i}"], "err": np.zeros(n, np.float32)}
             for i, n in enumerate(setup.layout.sizes)], index=None)
    state, out = _port_steps(tts, convert, setup, state, inp, name, (rank,))
    out["fsdp_axes"] = np.asarray(setup.fsdp_axes)
    out["compress_axes"] = np.asarray(setup.agg_cfg.compress_axes)
    out["p_fsdp"] = setup.p_fsdp
    out["local_shapes"] = np.asarray([str(tuple(p.shape)) for p in
                                      setup.model.parameters()])
    out["digest"] = tts.state_digest(list(setup.model.parameters()))
    out["unsharded"] = setup.model.final_norm.scale.detach().numpy()
    out["coords"] = [mesh_mod.coords()[a] for a in ("pod", "data")]
    if rank:
        out = {k: v for k, v in out.items() if not k.startswith(
            ("param/", "m/", "v/"))}
    del torch
    return out


def _run_port_gathers(inp):
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers as tlayers
    coords = (mesh_mod.coords()["pod"], mesh_mod.coords()["data"])
    rank = coords[0] * 2 + coords[1]
    out = {}
    for i, (axes, dim, quant, dtype) in enumerate(GATHERS):
        ctx = tlayers.ShardCtx(fsdp_axes=axes,
                               gather_quant="int8" if quant else None)
        dt = getattr(torch, dtype)
        w = torch.from_numpy(_gather_slice(inp[f"gw/{i}"], axes, dim,
                                           coords)).to(dt).requires_grad_()
        y = tlayers.fsdp_gather(w, ctx, dim)
        ct = torch.from_numpy(inp[f"gct/{i}"][rank]).to(dt)
        (g,) = torch.autograd.grad(y, w, ct)
        out[f"y/{i}"] = y.detach().float().numpy()
        out[f"g/{i}"] = g.float().numpy()
    return out


def _run_port_adafactor(inp):
    """The sharded Adafactor update (HSDP shards, two steps) against the
    unsharded update of the same global gradients, on the gathered
    arrays: returns the largest relative difference."""
    import torch

    from repro_torch import convert
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as tts
    setup, _ = _port_setup(tts, convert, VLM,
                           dict(optimizer="adafactor"), _start(inp, VLM))
    model = setup.model
    names = [n for n, _ in model.named_parameters()]
    full = {n: torch.from_numpy(v.copy())
            for n, v in _start(inp, VLM).items()}
    gen = torch.Generator().manual_seed(3)
    grads = [{n: torch.randn(full[n].shape, generator=gen) for n in names}
             for _ in range(STEPS)]
    cfg = opt_mod.OptConfig(name="adafactor")
    sharded = opt_mod.make("adafactor", cfg, setup.sharding)
    plain = opt_mod.make("adafactor", cfg)
    p_loc = list(model.parameters())
    p_full = [full[n] for n in names]
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


#: the families FSDP serves beside vlm and MoE: held against the port's
#: own DDP step (one step, fp32, uncompressed) on the same 4 ranks
FAMILY_ARCHS = ("tinyllama-1.1b", "zamba2-2.7b", "xlstm-350m",
                "seamless-m4t-medium")


def _run_port_families(rank):
    """Per arch of ``FAMILY_ARCHS`` (reduced, ``remat="full"``): one
    step of the ZeRO-3 FSDP step and of the replicated DDP step from the
    same parameters and batch; the largest parameter difference over
    ``2 * lr`` (global arrays) and the losses."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.train import train_step as tts
    out = {}
    for name in FAMILY_ARCHS:
        cfg = tcfgs.reduced(tcfgs.get(name))
        batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                    global_batch=GLOBAL_BATCH), 0)
        if cfg.family == "audio":
            batch["enc_embeds"] = np.random.default_rng(5).standard_normal(
                (GLOBAL_BATCH, SEQ, cfg.d_model)).astype(np.float32)
        batch = tts.split_batch(batch, RANKS, rank)
        got = {}
        for mode, ov in (("fsdp", dict(dp_mode="fsdp",
                                       fsdp_shard_pods=True)),
                         ("ddp", dict(dp_mode="ddp", zero1=False))):
            setup = tts.build(cfg, "cpu", remat="full", **ov)
            setup.model.ctx = dataclasses.replace(
                setup.model.ctx, compute_dtype=torch.float32)
            state = tts.init_state(setup, seed=3)
            state, m = tts.make_step(setup)(state, batch, LR)
            got[mode] = (m["loss"].item(), m["grad_norm"].item(),
                         convert.global_params(setup.model),
                         setup.fsdp_axes)
        (lf, gf, pf, axes), (ld, gd, pd, _) = got["fsdp"], got["ddp"]
        assert axes == ("pod", "data")
        out[f"{name}/loss"] = np.asarray([lf, ld])
        out[f"{name}/grad_norm"] = np.asarray([gf, gd])
        out[f"{name}/worst"] = max(
            (pf[k].float() - pd[k].float()).abs().max().item()
            for k in pd) / (2 * LR)
    return out


def _run_torch(d, rank, port):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        mesh_mod.init_pod_mesh(2, 2, torch.device("cpu"))
        inp = np.load(os.path.join(d, "in.npz"))
        np.savez(os.path.join(d, f"torch_gathers_{rank}.npz"),
                 **_run_port_gathers(inp))
        for case in CASES:
            np.savez(os.path.join(d, f"torch_{case}_{rank}.npz"),
                     **_run_port_case(inp, rank, case))
        np.savez(os.path.join(d, f"torch_adafactor_{rank}.npz"),
                 worst=_run_port_adafactor(inp))
        np.savez(os.path.join(d, f"torch_families_{rank}.npz"),
                 **_run_port_families(rank))
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
    d = str(tmp_path_factory.mktemp("fsdp"))
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
    return d


def _load(d, name):
    return np.load(os.path.join(d, f"{name}.npz"))


def _assert_close_to_lr(got, want, what, share=True):
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * STEPS + 1e-4, (what, diff.max())
    if share:
        assert (diff > LR / 2).mean() <= 0.02, (what,
                                                 (diff > LR / 2).mean())
    assert np.median(diff) <= LR / 50, (what, np.median(diff))


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_step_matches(pt, jx, start, what):
    for s in range(STEPS):
        np.testing.assert_allclose(pt[f"loss/{s}"], jx[f"loss/{s}"],
                                   rtol=1e-4, err_msg=f"{what} loss {s}")
        np.testing.assert_allclose(pt[f"grad_norm/{s}"],
                                   jx[f"grad_norm/{s}"], rtol=1e-3,
                                   err_msg=f"{what} grad norm {s}")
        np.testing.assert_allclose(pt[f"moe_aux/{s}"], jx[f"moe_aux/{s}"],
                                   rtol=1e-4, atol=1e-7,
                                   err_msg=f"{what} moe_aux {s}")
    names = sorted(k for k in jx.files if k.startswith("param/"))
    assert names == sorted(k for k in (getattr(pt, "files", None) or pt)
                           if k.startswith("param/"))
    small = []
    for k in names:
        leaf = k.split("/", 1)[1]
        assert pt[k].shape == jx[k].shape == start[leaf].shape, k
        _assert_close_to_lr(pt[k], jx[k], f"{what} {k}",
                            share=jx[k].size >= SMALL_LEAF)
        if jx[k].size < SMALL_LEAF:
            small.append((pt[k].ravel(), jx[k].ravel()))
        for mv in ("m", "v"):
            assert _rel(pt[f"{mv}/{leaf}"], jx[f"{mv}/{leaf}"]) <= 1e-2, (
                what, mv, leaf)
    _assert_close_to_lr(*(np.concatenate(x) for x in zip(*small)),
                        f"{what} small leaves")


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_step_matches_jax_on_four_ranks(results, case):
    d = results
    name, ov = CASES[case]
    jx = _load(d, f"jax_{case}")
    ports = [_load(d, f"torch_{case}_{r}") for r in range(RANKS)]
    want_fsdp = ["pod", "data"] if ov.get("fsdp_shard_pods") else ["data"]
    assert list(jx["fsdp_axes"]) == want_fsdp
    assert list(jx["compress_axes"]) == (
        [] if ov.get("fsdp_shard_pods") else ["pod"])
    for pt in ports:
        assert list(pt["fsdp_axes"]) == want_fsdp
        assert list(pt["compress_axes"]) == list(jx["compress_axes"])
        assert int(pt["p_fsdp"]) == 2 * len(want_fsdp)
        for s in range(STEPS):
            assert pt[f"loss/{s}"] == ports[0][f"loss/{s}"]
    start = _start(np.load(os.path.join(d, "in.npz")), name)
    _assert_step_matches(ports[0], jx, start, case)
    # every leaf moved, the embedding table too (weight decay)
    for k in (k for k in ports[0].files if k.startswith("param/")):
        assert not np.array_equal(ports[0][k], start[k.split("/", 1)[1]]), k


@pytest.mark.parametrize("case", list(CASES))
def test_pod_replicas_hold_the_same_shards(results, case):
    """HSDP: the ranks with the same ``data`` index (one per pod) hold the
    same shard bits and the two ``data`` ranks of a pod different
    shards; under ``fsdp_shard_pods`` every rank holds its own."""
    ports = [_load(results, f"torch_{case}_{r}") for r in range(RANKS)]
    by = {tuple(pt["coords"]): str(pt["digest"]) for pt in ports}
    if CASES[case][1].get("fsdp_shard_pods"):
        assert len(set(by.values())) == RANKS
    else:
        assert by[(0, 0)] == by[(1, 0)] and by[(0, 1)] == by[(1, 1)]
        assert by[(0, 0)] != by[(0, 1)]


@pytest.mark.parametrize("case", list(CASES))
def test_unsharded_leaves_drift_only_under_a_compressor(results, case):
    """A leaf FSDP does not shard (here ``final_norm.scale``) holds the
    same bits on every rank when nothing is compressed.  Under HSDP with
    PowerSGD over ``pod`` it rides buckets of each ``data`` rank's own
    shards through the lossy exchange, so the two ``data`` ranks of a pod
    end with different values, in the JAX package as in the port (a limit
    of the reference's HSDP, recorded in ROADMAP); each rank's copy is
    close to JAX's copy on the same device."""
    jx = _load(results, f"jax_{case}")
    ports = [_load(results, f"torch_{case}_{r}") for r in range(RANKS)]
    for r, pt in enumerate(ports):
        np.testing.assert_allclose(pt["unsharded"], jx[f"unsharded/{r}"],
                                   rtol=0, atol=2 * LR * STEPS + 1e-4)
    same_j = all(np.array_equal(jx[f"unsharded/{r}"], jx["unsharded/0"])
                 for r in range(RANKS))
    same_t = all(np.array_equal(pt["unsharded"], ports[0]["unsharded"])
                 for pt in ports)
    lossy = CASES[case][1].get("compression") == "powersgd"
    assert same_j == same_t == (not lossy)
    if lossy:       # the pod replicas agree with each other all the same
        for j in (jx, None):
            vals = [jx[f"unsharded/{r}"] for r in range(RANKS)] if j \
                is not None else [pt["unsharded"] for pt in ports]
            assert np.array_equal(vals[0], vals[2])
            assert np.array_equal(vals[1], vals[3])


def test_local_shard_shapes_follow_the_sharded_dims(results):
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_dims, param_layout
    for case, (name, ov) in CASES.items():
        cfg = _reduced(tcfgs, name)
        dims = param_dims(cfg)
        p = 4 if ov.get("fsdp_shard_pods") else 2
        want = []
        for leaf, shape, _ in param_layout(cfg):
            s = list(shape)
            if dims[leaf] is not None:
                s[dims[leaf]] //= p
            want.append(str(tuple(s)))
        assert list(_load(results, f"torch_{case}_0")["local_shapes"]) == \
            want, case


def test_gathers_match_jax(results):
    jx = _load(results, "jax_gathers")
    for r in range(RANKS):
        pt = _load(results, f"torch_gathers_{r}")
        for i, (axes, dim, quant, dtype) in enumerate(GATHERS):
            what = f"gather {i} {axes} dim {dim} int8 {quant} {dtype} " \
                f"rank {r}"
            want_y, want_g = jx[f"y/{i}"][r], jx[f"g/{i}"][r]
            if quant:
                np.testing.assert_allclose(
                    pt[f"y/{i}"], want_y, rtol=0,
                    atol=1e-6 * np.abs(want_y).max(), err_msg=what)
                # the quantization error is bounded by half a level
                w = np.load(os.path.join(results, "in.npz"))[f"gw/{i}"]
                assert np.abs(pt[f"y/{i}"] - w).max() <= \
                    np.abs(w).max() / 127 * 0.51 + 2 ** -7 * np.abs(w).max()
            else:
                np.testing.assert_array_equal(pt[f"y/{i}"], want_y,
                                              err_msg=what)
            if len(axes) == 1:      # a sum of two: one rounding, exact
                np.testing.assert_array_equal(pt[f"g/{i}"], want_g,
                                              err_msg=what)
            else:                   # of four: the order of the sum differs
                np.testing.assert_allclose(
                    pt[f"g/{i}"], want_g, rtol=1e-6,
                    atol=1e-6 * np.abs(want_g).max(), err_msg=what)


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_fsdp_step_serves_every_family(results, name):
    """The dense, hybrid (the LoRA patched into the shared block's
    shards), ssm and audio families under ZeRO-3 on 4 ranks: one step
    equals the replicated DDP step from the same parameters and batch
    (loss and grad norm to 1e-5, every parameter within ``lr / 10``:
    AdamW's first step moves an element by ``lr * g / (|g| + eps)``,
    which another summation order moves only where ``|g|`` is near
    ``eps``)."""
    for r in range(RANKS):
        pt = _load(results, f"torch_families_{r}")
        lf, ld = pt[f"{name}/loss"]
        np.testing.assert_allclose(lf, ld, rtol=1e-5)
        gf, gd = pt[f"{name}/grad_norm"]
        np.testing.assert_allclose(gf, gd, rtol=1e-5)
        assert float(pt[f"{name}/worst"]) <= 0.05, float(pt[f"{name}/worst"])


def test_sharded_adafactor_equals_the_unsharded_update(results):
    for r in range(RANKS):
        assert float(_load(results, f"torch_adafactor_{r}")["worst"]) \
            <= 1e-6


@pytest.fixture
def own_world():
    """A one-rank process group that ``train_step.build`` joins is left
    as the test found it: destroyed after the test when it made one, so
    a later file in this process can start its own."""
    import torch.distributed as dist
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


def test_one_rank_fsdp_step_matches_jax_one_device(results, own_world):
    """The degenerate case: one device drops the size-1 FSDP axis in both
    packages and the step runs unsharded."""
    import torch

    from repro_torch import convert
    from repro_torch.train import train_step as tts
    jx = _load(results, "jax_one")
    assert list(jx["fsdp_axes"]) == [] and int(jx["p_fsdp"]) == 1
    inp = np.load(os.path.join(results, "in.npz"))
    setup, state = _port_setup(tts, convert, VLM, {}, _start(inp, VLM))
    assert setup.fsdp_axes == () and setup.p_fsdp == 1
    assert setup.arch.plan.dp_mode == "fsdp" and not setup.zero1
    assert setup.model.fsdp_size == 1
    _, pt = _port_steps(tts, convert, setup, state, inp, VLM, None)
    _assert_step_matches(pt, jx, _start(inp, VLM), "one rank")
    # the JAX package's microbatch split fails on (3, B, S) positions;
    # the port refuses it rather than guess
    assert str(jx["accum2_error"]), "JAX's accum=2 vlm step ran"
    setup, state = _port_setup(tts, convert, VLM, {}, _start(inp, VLM))
    with pytest.raises(ValueError, match="mrope_positions"):
        tts.make_step(setup, accum=2)(state, _batch(inp, VLM, 0), LR)
    del torch


@pytest.mark.parametrize("name", ["arctic-480b", "granite-8b",
                                  "mistral-nemo-12b", "qwen2-moe-a2.7b",
                                  "qwen2-vl-7b", "qwen3-32b",
                                  "seamless-m4t-medium", "tinyllama-1.1b",
                                  "xlstm-350m", "zamba2-2.7b"])
def test_every_arch_builds_on_its_own_plan(name, own_world):
    """``train_step.build`` on each arch's configured plan (reduced, one
    CPU rank) raises nothing, as the JAX package's builds; an FSDP plan
    with ``overlap=True`` raises JAX's ``ValueError``."""
    from repro_torch.configs import base as tcfgs
    from repro_torch.train import train_step as tts
    cfg = tcfgs.reduced(tcfgs.get(name))
    setup = tts.build(cfg, "cpu")
    assert setup.arch.plan == cfg.plan and setup.fsdp_axes == ()
    if cfg.plan.dp_mode == "fsdp":
        with pytest.raises(ValueError, match="FSDP"):
            tts.build(cfg, "cpu", overlap=True)


# ------------------------------------------------------ the sharded dims
@pytest.mark.parametrize("name", ["arctic-480b", "granite-8b",
                                  "mistral-nemo-12b", "qwen2-moe-a2.7b",
                                  "qwen2-vl-7b", "qwen3-32b",
                                  "seamless-m4t-medium", "tinyllama-1.1b",
                                  "xlstm-350m", "zamba2-2.7b"])
def test_sharded_dims_equal_jax_specs(name):
    """``param_dims`` against JAX's ``abstract_init`` specs with
    ``fsdp_axes=("data",)``: the one dim whose entry names ``data``, or
    None, leaf by leaf in leaf order, for every reduced arch (the six
    FSDP archs and the four DDP ones, which FSDP can run by override)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import base as jcfgs
    from repro.models import Model as JModel
    from repro.models.layers import ShardCtx as JShardCtx
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_dims
    _, specs = JModel(jcfgs.reduced(jcfgs.get(name))).abstract_init(
        JShardCtx(fsdp_axes=("data",)))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        dims = [i for i, e in enumerate(s) if e is not None and "data" in (
            e if isinstance(e, tuple) else (e,))]
        assert len(dims) <= 1
        want[".".join(str(k.key) for k in path)] = dims[0] if dims else None
    got = param_dims(tcfgs.reduced(tcfgs.get(name)))
    assert list(got.items()) == list(want.items())
    assert any(v is not None for v in got.values())


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), sys.argv[4])
