"""Serving on ``data 2 x model 2``: the port's four gloo ranks against
the JAX package's ``build_serve`` on four fake CPU devices, and against
the port's own one-rank run.

Processes started together: two JAX processes at XLA's optimisation
level 0 (``JAX_PARTS``, two cells each), the port's four ranks
(``OMP_NUM_THREADS=1`` each) and the port on one rank.  Every cell runs
prefill and ``STEPS`` decode steps from the same global parameters
(drawn here with numpy) on the same global batch, the decode steps fed
the same tokens, in fp32 (parameters, compute and caches):

* ``tp``: the reduced ``tinyllama-1.1b``, batch 4 (2 rows a data rank),
  TP over ``model``;
* ``cp``: the same at batch 1, so the cache is context-parallel over
  ``data`` (each data rank owns half of the capacity); the prompt is
  longer than half the cache, so prefill spans both ranks and decode
  writes into rank 1's span;
* ``fsdp``: the reduced ``qwen3-32b`` (qk-norm) with its plan's
  ``serve_fsdp``: the parameters sharded over ``data`` too;
* ``moe2d``: the reduced ``arctic-480b`` with ``serve_moe_ep_data``: the
  2-D layout, experts over ``data`` and ``d_ff`` over ``model``, at the
  config's capacity factor; ``moe2d-nodrop`` the same at factor 8.

Each step's global logits, on every rank, within ``2e-5 * max(1,
max|JAX|)`` of JAX's (every cell but ``moe2d-nodrop``) and of the port's
one-rank run's (every cell but ``moe2d``, whose data ranks fill expert
slots of their own and so drop other picks than one rank: ``ONE_RANK``);
the ranks hold the same logits.  ``serve_params`` draws the same global
weights on four ranks as on one (``DRAWN``, in blocks of rows).  The
context-parallel cell's caches equal JAX's on the
valid slots (position below ``cur_len``): JAX's prefill wraps the
negative slot indices of the earlier span into rank 1's cache (ROADMAP
§3), which the port drops; no valid slot holds them.

This file is also the subprocess script: ``python test_torch_serve_step.py
jax DIR PART``, ``... torch DIR RANK PORT`` or ``... one DIR``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_tp_step import _env, _nest

RANKS = 4
STEPS = 2
TIMEOUT_S = 300
RTOL = 2e-5
#: cell -> (arch, global batch, prompt length, cache capacity, the MoE
#: capacity factor or None for the config's)
CELLS = {"tp": ("tinyllama-1.1b", 4, 12, 32, None),
         "cp": ("tinyllama-1.1b", 1, 20, 32, None),
         "fsdp": ("qwen3-32b", 4, 12, 32, None),
         "moe2d": ("arctic-480b", 4, 12, 32, None),
         "moe2d-nodrop": ("arctic-480b", 4, 12, 32, 8.0)}
#: the JAX subprocesses, run side by side: the cells each computes
JAX_PARTS = (("tp", "cp"), ("fsdp", "moe2d"))
#: the cells held to the port's one-rank run: each data rank of the 2-D
#: layout fills per-source expert slots of its own, so the config's
#: capacity drops other picks than one rank does; at factor 8 nothing
#: is dropped on either
ONE_RANK = ("tp", "cp", "fsdp", "moe2d-nodrop")
#: the archs whose ``serve_params`` draw is held across meshes: TP, the
#: FSDP shards, the experts over ``data`` and ``d_ff`` over ``model``
DRAWN = ("qwen3-32b", "arctic-480b")


def _reduced(cfgs, name, factor=None):
    cfg = cfgs.reduced(cfgs.get(name))
    if factor:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
    return cfg


def _make_inputs(d):
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_layout
    rng = np.random.default_rng(37)
    arrays = {}
    for name in sorted({c[0] for c in CELLS.values()}):
        for leaf, shape, init in param_layout(_reduced(tcfgs, name), 2):
            arrays[f"param/{name}/{leaf}"] = (
                np.ones(shape) if init is None
                else init * np.clip(rng.standard_normal(shape), -3, 3)
            ).astype(np.float32)
    for cell, (name, b, s, _, _) in CELLS.items():
        vocab = _reduced(tcfgs, name).vocab
        arrays[f"tokens/{cell}"] = rng.integers(
            0, vocab, (b, s + STEPS)).astype(np.int32)
    np.savez(os.path.join(d, "in.npz"), **arrays)


def _params(inp, name):
    pre = f"param/{name}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def _batches(inp, cell):
    """The prefill batch, then each decode step's."""
    _, b, s, _, _ = CELLS[cell]
    toks = inp[f"tokens/{cell}"]
    out = [{"tokens": toks[:, :s]}]
    for i in range(STEPS):
        out.append({"tokens": toks[:, s + i:s + i + 1],
                    "cur_len": np.full((b,), s + i, np.int32)})
    return out


# ------------------------------------------------------------- JAX side
def _run_jax(d, part):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    from repro.configs.shapes import ShapeConfig
    from repro.parallel.compat import make_mesh
    from repro.serving import serve_step as ss
    assert len(jax.devices()) == RANKS
    inp = np.load(os.path.join(d, "in.npz"))
    mesh = make_mesh((2, 2), ("data", "model"))
    f32 = jnp.float32
    for cell in JAX_PARTS[int(part)]:
        name, b, _, cap, factor = CELLS[cell]
        setup = ss.build_serve(_reduced(jcfgs, name, factor), mesh,
                               ShapeConfig(cell, "decode", cap, b),
                               param_dtype=f32)
        setup = dataclasses.replace(
            setup, ctx=dataclasses.replace(setup.ctx, compute_dtype=f32),
            cache_sds_local=jax.tree.map(
                lambda s: jax.ShapeDtypeStruct(s.shape, f32),
                setup.cache_sds_local,
                is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
        params = jax.device_put(
            jax.tree.map(jnp.asarray, _nest(_params(inp, name))),
            setup.sharding(setup.param_specs))
        first, *rest = [jax.tree.map(jnp.asarray, x)
                        for x in _batches(inp, cell)]
        logits, cache = ss.make_prefill(setup)(first)(params, first)
        out = {"0": np.asarray(logits)}
        decode = ss.make_decode(setup)(rest[0])
        for i, batch in enumerate(rest):
            logits, cache = decode(params, cache, batch)
            out[str(i + 1)] = np.asarray(logits)
        out["k"], out["v"] = (np.asarray(cache[k]) for k in "kv")
        np.savez(os.path.join(d, f"jax_{cell}.npz"), **out)


# ------------------------------------------------------------ port side
def _port_cell(inp, cell, device="cpu"):
    """(the logits of each step, this rank's cache) of ``cell`` on the
    current mesh."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.serving import serve_step as ss
    name, b, _, cap, factor = CELLS[cell]
    setup = ss.build_serve(_reduced(tcfgs, name, factor),
                           ShapeConfig(cell, "decode", cap, b),
                           param_dtype=torch.float32, device=device,
                           compute_dtype=torch.float32)
    setup.cache_dtype = torch.float32
    convert.load_params(setup.model, _nest(_params(inp, name)))
    first, *rest = _batches(inp, cell)
    logits, cache = ss.make_prefill(setup)(first)
    out = [logits]
    decode = ss.make_decode(setup)
    for batch in rest:
        logits, cache = decode(cache, batch)
        out.append(logits)
    flat = _params(inp, name)
    back = convert.global_params(setup.model)
    meta = {"cp": setup.context_parallel, "fsdp": setup.ctx.fsdp_axes,
            "ep": setup.ctx.moe_ep_axis, "tp": setup.ctx.tp,
            "round_trip": all(np.array_equal(back[k].numpy(), v)
                              for k, v in flat.items())}
    return [x.numpy() for x in out], cache, meta


def _drawn(name):
    """``serve_params``' global weights of the reduced ``name`` on the
    current mesh, drawn in blocks of a few rows (``Model.init_params``'
    ``DRAW_BLOCK`` cut so that every leaf takes the blocked path)."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models import model as model_mod
    from repro_torch.serving import serve_step as ss
    setup = ss.build_serve(_reduced(tcfgs, name),
                           ShapeConfig("draw", "decode", 32, 4),
                           device="cpu")
    block, model_mod.DRAW_BLOCK = model_mod.DRAW_BLOCK, 100
    try:
        ss.serve_params(setup, torch.Generator().manual_seed(5))
    finally:
        model_mod.DRAW_BLOCK = block
    return {k: v.float().numpy()
            for k, v in convert.global_params(setup.model).items()}


def _run_torch(d, rank, port):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        mesh_mod.init_mesh(2, torch.device("cpu"))
        inp = np.load(os.path.join(d, "in.npz"))
        for cell in CELLS:
            logits, cache, meta = _port_cell(inp, cell)
            np.savez(os.path.join(d, f"torch_{cell}_{rank}.npz"),
                     k=cache["k"].numpy(), v=cache["v"].numpy(),
                     meta=np.asarray(repr(meta)),
                     **{str(i): x for i, x in enumerate(logits)})
        for name in DRAWN:
            drawn = _drawn(name)
            if rank == 0:
                np.savez(os.path.join(d, f"drawn_{name}_4.npz"), **drawn)
    finally:
        dist.destroy_process_group()


def _run_one(d):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_world(torch.device("cpu"))
    try:
        inp = np.load(os.path.join(d, "in.npz"))
        for cell in ONE_RANK:
            logits, _, _ = _port_cell(inp, cell)
            np.savez(os.path.join(d, f"one_{cell}.npz"),
                     **{str(i): x for i, x in enumerate(logits)})
        for name in DRAWN:
            np.savez(os.path.join(d, f"drawn_{name}_1.npz"), **_drawn(name))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("serve_step"))
    _make_inputs(d)
    me = os.path.abspath(__file__)
    xla = os.environ.get("XLA_FLAGS", "") \
        + f" --xla_force_host_platform_device_count={RANKS}" \
        + " --xla_backend_optimization_level=0"
    port = str(free_port())
    one = _env(OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, me, "jax", d, str(i)],
                              env=_env(XLA_FLAGS=xla),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(len(JAX_PARTS))]
    procs += [subprocess.Popen([sys.executable, me, "torch", d, str(r),
                                port], env=one, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(RANKS)]
    procs.append(subprocess.Popen([sys.executable, me, "one", d], env=one,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
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


def _err(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("cell", [c for p in JAX_PARTS for c in p])
def test_logits_match_jax_on_every_rank(results, cell):
    jx = _load(results, f"jax_{cell}")
    for r in range(RANKS):
        pt = _load(results, f"torch_{cell}_{r}")
        for i in range(STEPS + 1):
            want = jx[str(i)]
            assert pt[str(i)].shape == want.shape, (cell, r, i)
            err = _err(pt[str(i)], want)
            assert err <= RTOL, f"{cell} rank {r} step {i}: {err:.3g}"


@pytest.mark.parametrize("cell", ONE_RANK)
def test_four_ranks_match_the_one_rank_run(results, cell):
    one = _load(results, f"one_{cell}")
    pts = [_load(results, f"torch_{cell}_{r}") for r in range(RANKS)]
    for i in range(STEPS + 1):
        err = _err(pts[0][str(i)], one[str(i)])
        assert err <= RTOL, f"{cell} step {i}: {err:.3g}"
        for pt in pts[1:]:
            np.testing.assert_array_equal(pt[str(i)], pts[0][str(i)])


def test_cells_run_the_layouts_they_name(results):
    """The setups: context parallelism exactly at batch 1, FSDP over
    ``data`` under ``serve_fsdp``, the experts over ``data`` under
    ``serve_moe_ep_data``; on every rank, the global parameters gathered
    back from the loaded shards (``convert.global_params``) are the JAX
    tree's bit for bit."""
    want = {"tp": (False, (), None), "cp": (True, (), None),
            "fsdp": (False, ("data",), None), "moe2d": (False, (), "data"),
            "moe2d-nodrop": (False, (), "data")}
    for cell, (cp, fsdp, ep) in want.items():
        meta = eval(str(_load(results, f"torch_{cell}_0")["meta"]))
        assert (meta["cp"], meta["fsdp"], meta["ep"], meta["tp"]) == \
            (cp, fsdp, ep, 2), cell
        for r in range(RANKS):
            meta = eval(str(_load(results, f"torch_{cell}_{r}")["meta"]))
            assert meta["round_trip"], (cell, r)


@pytest.mark.parametrize("name", DRAWN)
def test_serve_params_draws_the_same_weights_on_any_mesh(results, name):
    one = _load(results, f"drawn_{name}_1")
    four = _load(results, f"drawn_{name}_4")
    assert one.files == four.files
    for k in one.files:
        np.testing.assert_array_equal(four[k], one[k], err_msg=k)


def test_context_parallel_cache_matches_jax_on_valid_slots(results):
    """Rank (data i, model m) holds positions [16 i, 16 i + 16) of the kv
    heads of model rank m: equal to JAX's global cache there, on the
    slots below the last ``cur_len + 1``."""
    _, _, s, cap, _ = CELLS["cp"]
    valid = s + STEPS
    jx = _load(results, "jax_cp")
    span = cap // 2
    for r in range(RANKS):
        i, m = r // 2, r % 2
        pt = _load(results, f"torch_cp_{r}")
        for k in "kv":
            got = pt[k]
            kv = got.shape[3]
            want = jx[k][:, :, i * span:(i + 1) * span, m * kv:(m + 1) * kv]
            n = max(0, min(span, valid - i * span))
            np.testing.assert_allclose(got[:, :, :n], want[:, :, :n],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
            assert not got[:, :, n:].any(), f"rank {r} {k}: an invalid slot"


if __name__ == "__main__":
    what = sys.argv[1]
    if what == "jax":
        _run_jax(sys.argv[2], sys.argv[3])
    elif what == "torch":
        _run_torch(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    else:
        _run_one(sys.argv[2])
