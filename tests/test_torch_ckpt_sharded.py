"""Sharded checkpoints: FSDP, HSDP, TP and EP states saved in the JAX
package's global layout and restored, elastic across FSDP and TP degrees.

* In process (a): ``convert.to_padded`` / ``to_logical`` / ``relayout``
  for every padded leaf of the six reduced families at every ``tp`` of
  1, 2, 4 and 8 at which the family builds, with a vocabulary (509), a
  GQA (6 heads over 2 kv heads, 12 over 4) and an expert count (5) that
  pad, against the JAX package's ``layers.pad_q_columns``, ``pad_vocab``
  and ``moe.pad_experts`` stacking on the same numpy draw.
* Four gloo ranks, two launcher ranks and two JAX processes on 4 fake
  CPU devices (``JAX_PARTS``), all started together, ``OMP_NUM_THREADS=1``
  each (this file is also their script: ``python
  test_torch_ckpt_sharded.py torch DIR RANK PORT PORT2``, ``... launcher
  DIR RANK PORT PORT2``, ``... jax DIR PART``):
  - (b) every case of ``CASES`` (``data 2 x model 2``, the last on ``pod
    2 x data 1 x model 2``; Adafactor's factored statistics in one):
    step 1 from ``init_state(seed=0)``, a save,
    step 2; then a fresh setup restores step 1 and takes step 2.  Its
    loss and ``state_digest`` equal the uninterrupted run's, bit for bit,
    on every rank.
  - (c) JAX's ``ckpt.restore`` of each port file against JAX's
    ``abstract_state`` at the same mesh gives every leaf the bits of the
    port's tree, gathered here with other collectives
    (``convert.to_global``, ``all_gather``); the ZeRO-1 shard rows are
    JAX's device order: JAX's ``_fill_zero1_master`` of the restored
    parameters is the restored master rounded to bf16, row by row.
  - (d) JAX writes the dense FSDP x TP and the ZeRO-1 PowerSGD states at
    ``data 2 x model 2`` (``init_state`` with random moments, master and
    error feedback); the port restores each equal, bit for bit, to
    ``convert``'s carry of the same state.
  - (e) the FSDP x TP file restored at ``data 4 x model 1``, ``data 1 x
    model 4`` and on one rank, the MoE file (5 experts, padded to 6) at
    ``model 4`` (8), the ZeRO-1 PowerSGD file at ``data 4`` and ``model
    4``: logical parameters and moments bit-equal, the next loss within
    ``ELASTIC_RTOL`` of the source layout's (fp32 compute; the MoE
    capacity is large enough that nothing drops at either layout),
    ``agg`` rebuilt with PowerSGD ``q`` not zero, the master equal to the
    restored parameters, ``m`` and ``v`` zero, ``t`` kept.
  - (f) ``launch.train --tp 2 --ckpt-dir D --ckpt-every 1`` on two ranks,
    run twice: the second run resumes and takes only the new step.
  - (g) the JAX package's limits, pinned: its manager restores the FSDP
    x TP file at ``model 4`` with every padded leaf (tables, ``wq``,
    ``wo``) zero, and stops at its leaf-count assertion on the ZeRO-1
    PowerSGD file at ``data 4`` (another number of shard buckets).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE, MOE, HYBRID = "tinyllama-1.1b", "qwen2-moe-a2.7b", "zamba2-2.7b"
SSM, AUDIO, VLM = "xlstm-350m", "seamless-m4t-medium", "qwen2-vl-7b"
RANKS = 4
LAUNCHER_RANKS = 2
SEQ = 16
GLOBAL_BATCH = 8
LR = 1e-3
BUCKET_MB = 0.0625
TIMEOUT_S = 240
#: the next loss after an elastic restore against the source layout's
ELASTIC_RTOL = 1e-5
#: a vocabulary and GQA heads that pad: 509 rows pad at every tp > 1; 6
#: q heads over 2 kv heads at tp 4
GQA = dict(vocab=509, n_heads=6, n_kv_heads=2)

#: case -> (arch, config overrides, plan overrides, mesh): "dm" is data 2
#: x model 2, "pdm" pod 2 x data 1 x model 2
CASES = {
    "dense-fsdp": (DENSE, GQA, dict(dp_mode="fsdp", zero1=False), "dm"),
    # Adafactor's row and column statistics: one spans a sharded dim
    "adafactor-fsdp": (DENSE, GQA, dict(dp_mode="fsdp", zero1=False,
                                        optimizer="adafactor"), "dm"),
    "zero1-powersgd": (DENSE, GQA, dict(dp_mode="ddp", zero1=True,
                                        compression="powersgd"), "dm"),
    "overlap-ef-randomk": (DENSE, GQA, dict(
        dp_mode="ddp", zero1=True, overlap=True, compression="ef:randomk"),
        "dm"),
    "moe-ep": (MOE, dict(vocab=509, moe=dict(n_experts=5,
                                             capacity_factor=8.0)),
               dict(dp_mode="ddp", zero1=False), "dm"),
    "hybrid": (HYBRID, dict(vocab=509), dict(dp_mode="ddp", zero1=True),
               "dm"),
    # one mLSTM head: at model 2 each rank holds half its values
    "ssm-vparts": (SSM, dict(n_heads=1), dict(dp_mode="ddp", zero1=True),
                   "dm"),
    "audio": (AUDIO, {}, dict(dp_mode="ddp", zero1=True), "dm"),
    "vlm-fsdp": (VLM, dict(vocab=509), dict(dp_mode="fsdp", zero1=False),
                 "dm"),
    "zero1-pod": (DENSE, GQA, dict(dp_mode="ddp", zero1=True), "pdm"),
}
#: the cases JAX writes a file of (d)
JAX_FILES = ("dense-fsdp", "zero1-powersgd")
#: the cases whose ZeRO-1 rows are held to JAX's device order (c)
ROW_ORDER = ("zero1-powersgd", "zero1-pod")
#: (e): case -> the layouts it is restored at ((data, model), or "one")
ELASTIC = {"dense-fsdp": ((4, 1), (1, 4), "one"),
           "moe-ep": ((1, 4),),
           "zero1-powersgd": ((4, 1), (1, 4))}
#: the JAX subprocesses, run side by side
JAX_PARTS = ("write", "read")


def _arch(pkg, case):
    """The case's reduced config from ``pkg`` (either package's
    ``configs.base``), its plan overridden."""
    name, extra, plan, _ = CASES[case]
    cfg = pkg.reduced(pkg.get(name))
    kw = dict(extra)
    if "moe" in kw:
        kw["moe"] = dataclasses.replace(cfg.moe, **kw["moe"])
    cfg = dataclasses.replace(cfg, **kw)
    return dataclasses.replace(cfg, plan=dataclasses.replace(
        cfg.plan, bucket_mb=BUCKET_MB, **plan))


def _path(top: str, name: str) -> str:
    """The JAX path of parameter ``name`` under ``top``."""
    return "/".join([f"['{top}']"] + [f"['{k}']" for k in name.split(".")])


def _marker(d, name):
    with open(os.path.join(d, name), "w") as f:
        f.write("done")


def _wait(d, name, timeout=TIMEOUT_S):
    t0 = time.time()
    while not os.path.exists(os.path.join(d, name)):
        if time.time() - t0 > timeout:
            raise TimeoutError(name)
        time.sleep(0.1)


# ------------------------------------------------- (a) the layout helpers
#: reduced family -> config overrides (every one pads its vocabulary; the
#: dense GQA pads at tp 4, the vlm's at tp 8, the MoE's experts at 2-8)
LAYOUT_CFGS = {DENSE: GQA, MOE: dict(vocab=509, moe=dict(n_experts=5)),
               HYBRID: dict(vocab=509), SSM: dict(vocab=509),
               AUDIO: dict(vocab=509),
               VLM: dict(vocab=509, n_heads=12, n_kv_heads=4)}


def _layout_cfg(pkg, name):
    cfg = pkg.reduced(pkg.get(name))
    kw = dict(LAYOUT_CFGS[name])
    if "moe" in kw:
        kw["moe"] = dataclasses.replace(cfg.moe, **kw["moe"])
    return dataclasses.replace(cfg, **kw)


def _jax_padded(jcfg, name, logical, tp):
    """The JAX package's padded layout of ``logical`` at ``tp``."""
    import jax.numpy as jnp

    from repro.models import layers as jl
    from repro.models import moe as jmoe
    if name in ("embed.table", "unembed.table"):
        extra = jl.pad_vocab(jcfg.vocab, tp) - jcfg.vocab
        return np.concatenate(
            [logical, np.zeros((extra,) + logical.shape[1:], logical.dtype)])
    if ".experts." in name or name.endswith("router"):
        dim = -3 if ".experts." in name else -1
        e = jcfg.moe.n_experts
        shape = list(logical.shape)
        shape[dim] = jmoe.pad_experts(e, tp) - e
        return np.concatenate([logical, np.zeros(shape, logical.dtype)],
                              axis=dim)
    lay = jl.head_layout(jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim, tp)
    rows = name.endswith("wo.w")
    x = np.swapaxes(logical, -1, -2) if rows else logical
    flat = x.reshape((-1,) + x.shape[-2:])
    out = np.stack([np.asarray(jl.pad_q_columns(jnp.asarray(m), lay))
                    for m in flat]).reshape(x.shape[:-1] + (-1,))
    return np.swapaxes(out, -1, -2) if rows else out


@pytest.mark.parametrize("name", list(LAYOUT_CFGS))
def test_layout_round_trip_against_jax_padding(name):
    """Every padded leaf at every tp the family builds at: ``to_padded``
    of a logical draw is JAX's padding of it, ``to_logical`` gives it
    back, ``relayout`` from any other tp lands on it; the leaves with no
    padded dim have one shape at every tp."""
    from repro.configs import base as jcfgs
    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model, param_layout
    cfg, jcfg = _layout_cfg(tcfgs, name), _layout_cfg(jcfgs, name)
    logical = {n: s for n, s, _ in param_layout(cfg, 1)}
    tps = []
    for tp in (1, 2, 4, 8):
        try:
            Model(cfg, ShardCtx(tp=tp), device="meta")
        except ValueError:
            continue
        tps.append(tp)
    rng = np.random.default_rng(5)
    draws = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in logical.items()
             if convert.padded_dim(n) is not None}
    assert len(tps) >= 2 and draws
    padded_at, grew = {}, set()
    for tp in tps:
        for n, shape, _ in param_layout(cfg, tp):
            if n not in draws:
                assert shape == logical[n], (n, tp)
                continue
            got = convert.to_padded(cfg, n, draws[n], tp)
            assert got.shape == shape, (n, tp)
            np.testing.assert_array_equal(
                got, _jax_padded(jcfg, n, draws[n], tp), err_msg=f"{n} {tp}")
            np.testing.assert_array_equal(
                convert.to_logical(cfg, n, got, tp), draws[n])
            padded_at[(n, tp)] = got
            if shape != logical[n]:
                grew.add(convert.padded_dim(n)[0])
    for (n, a), got in padded_at.items():
        for b in tps:
            np.testing.assert_array_equal(
                convert.relayout(cfg, n, got, a, b), padded_at[(n, b)])
    want = {"vocab"} | ({"heads"} if name in (DENSE, VLM) else set()) \
        | ({"experts"} if name == MOE else set())
    assert want <= grew, (name, grew)


def test_per_rank_rows_of_bf16_and_keys_round_trip(tmp_path):
    """A per-rank bf16 leaf (raw bytes, each rank's row a run of them) and
    a per-rank key (uint32 words) written by their rank into the file
    ``save`` makes, read back by the port and by JAX's ``restore``."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.checkpoint import checkpoint as jckpt
    from repro_torch.checkpoint import checkpoint as ckpt
    gen = torch.Generator().manual_seed(0)
    bf = torch.randn((3, 4), generator=gen).to(torch.bfloat16)
    words = torch.tensor([[1, 2], [2**32 - 1, 7]], dtype=torch.int64)
    state = {"a": ckpt.PerRank(bf),
             "k": ckpt.PerRank(words, ckpt.PRNG_IMPL),
             "p": torch.arange(3.0)}
    ckpt.save(str(tmp_path), 1, state)
    like = {"a": ckpt.Leaf((1, 3, 4), "bfloat16", True),
            "k": ckpt.Leaf((1, 2), "uint32", True, ckpt.PRNG_IMPL),
            "p": ckpt.Leaf((3,), "float32")}
    got, _ = ckpt.restore(str(tmp_path), 1, like)
    assert torch.equal(got["a"].view(torch.int16), bf.view(torch.int16))
    assert torch.equal(got["k"], words) and torch.equal(got["p"], state["p"])
    key = jax.eval_shape(lambda: jax.random.split(jax.random.key(0), 2))
    jgot, _ = jckpt.restore(str(tmp_path), 1, {
        "a": jax.ShapeDtypeStruct((1, 3, 4), jnp.bfloat16),
        "k": jax.ShapeDtypeStruct((1, 2), key.dtype),
        "p": jax.ShapeDtypeStruct((3,), jnp.float32)})
    np.testing.assert_array_equal(
        np.asarray(jgot["a"])[0].view(np.uint16),
        bf.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jgot["k"]))[0],
        words.numpy().astype(np.uint32))


# ---------------------------------------------------------- the port side
def _mesh(kind):
    """(procs, local, tp) of a mesh name."""
    return {"dm": (1, 2, 2), "pdm": (2, 1, 2)}[kind]


def _init_mesh(kind):
    import torch

    from repro_torch.launch import mesh as mesh_mod
    procs, local, tp = kind if isinstance(kind, tuple) else _mesh(kind)
    if procs == 1:
        return mesh_mod.init_mesh(tp, torch.device("cpu"))
    return mesh_mod.init_pod_mesh(procs, local, torch.device("cpu"), tp=tp)


def _setup(case):
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.train import train_step as ts
    setup = ts.build(_arch(tcfgs, case), "cpu")
    setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                          compute_dtype=torch.float32)
    return setup


def _batch(setup, step):
    """This rank's rows of the global batch of ``step`` (and its frontend
    inputs)."""
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.inputs import with_frontend_inputs
    from repro_torch.train import train_step as ts
    cfg = setup.arch
    b = with_frontend_inputs(cfg, batch_at(DataConfig(
        vocab=cfg.vocab, seq_len=SEQ, global_batch=GLOBAL_BATCH), step),
        step)
    return ts.split_batch(b, setup.p_dp, mesh_mod.rank(setup.dp_axes))


def _np(t):
    """A host tensor's bits as numpy (bf16 as uint16)."""
    import torch
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _rows(t, prng=False):
    """Every rank's ``t`` stacked in world-rank order (all_gather)."""
    import torch
    import torch.distributed as dist
    t = t.detach().contiguous()
    got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(got, t)
    out = _np(torch.stack(got))
    return out.astype(np.uint32) if prng else out


def _stat_global(setup, name, key, t):
    """Adafactor's statistic ``key`` of parameter ``name`` gathered over
    the axes of the parameter dims it keeps (``r`` all but the last,
    ``c`` all but the second to last, ``v`` all)."""
    from repro_torch import convert
    from repro_torch.models.layers import fsdp_dim
    model = setup.model
    n = len(model.global_shape(name))
    split = [()] * n
    if setup.fsdp_axes and fsdp_dim(name) is not None:
        split[fsdp_dim(name) % n] = tuple(setup.fsdp_axes)
    if model.tp_dims[name] is not None:
        split[model.tp_dims[name]] += ("model",)
    dims = {"r": list(range(n))[:-1],
            "c": list(range(n))[:-2] + [n - 1]}.get(key, list(range(n)))
    return _np(convert.gather_global(t, [split[d] for d in dims]))


def _gathered_tree(setup, state) -> dict:
    """path -> the global array of every leaf of ``state``'s TrainState,
    gathered with ``convert.to_global`` and ``all_gather`` (every rank
    calls it)."""
    from repro_torch import convert
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint.manager import _nest
    model = setup.model
    names = [n for n, _ in model.named_parameters()]

    def glob(values):
        return _nest(names, [_np(convert.to_global(model, n, v))
                             for n, v in zip(names, values)])

    def stats(values):
        return _nest(names, [{k: _stat_global(setup, n, k, t)
                              for k, t in v.items()}
                             for n, v in zip(names, values)])

    def agg(st):
        return type(st)(*(agg(v) if isinstance(v, tuple)
                          else _rows(v, f == "key")
                          for f, v in zip(st._fields, st)))
    opt = state["opt"]
    if setup.zero1:
        opt_tree = {"t": np.int32(opt["t"]),
                    "shard": {k: _rows(v) for k, v in opt["shard"].items()}}
    else:
        opt_tree = {k: np.int32(v) if k == "t" else
                    stats(v) if k == "s" else glob(v)
                    for k, v in opt.items()}
    tree = {"step": np.int32(state["step"]), "params": glob(state["params"]),
            "opt": opt_tree, "agg": tuple(agg(s) for s in state["agg"])}
    return {p: np.asarray(x) for p, x in ckpt.items(tree)}


def _resume_case(d, case, rank) -> dict:
    """(b): the uninterrupted run with a save after step 1, then a fresh
    setup restored from it taking step 2."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train import train_step as ts
    _init_mesh(CASES[case][3])
    ck = os.path.join(d, "port_ckpt", case)
    setup = _setup(case)
    state = ts.init_state(setup, seed=0)
    step = ts.make_step(setup)
    b0, b1 = _batch(setup, 0), _batch(setup, 1)
    state, _ = step(state, b0, LR)
    CheckpointManager(ck, setup).save(1, state, cursor=1)
    at_1 = ts.state_digest(state)
    tree = _gathered_tree(setup, state)
    if rank == 0:
        np.savez(os.path.join(d, f"port_{case}.npz"), **tree)
    state, m = step(state, b1, LR)
    fresh = _setup(case)
    back, cursor = CheckpointManager(ck, fresh).restore(1)
    restored = ts.state_digest(back) == at_1
    back, m_b = ts.make_step(fresh)(back, b1, LR)
    return {"loss": m["loss"].item(), "loss_resumed": m_b["loss"].item(),
            "same": ts.state_digest(state) == ts.state_digest(back),
            "restored": restored, "cursor": cursor}


def _jax_state(d, case, setup, rank):
    """``convert``'s carry of the JAX state of ``case`` (``jax_state_<case>
    .npz``, global arrays) onto this rank."""
    import torch

    from repro_torch import convert
    src = np.load(os.path.join(d, f"jax_state_{case}.npz"))
    model = setup.model

    def tensor(path, like):
        a = src[path]
        if like.dtype == torch.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    params = [model.shard_slice(n, tensor(_path("params", n), p)).clone()
              for n, p in model.named_parameters()]
    t = int(src["['opt']/['t']"])
    if setup.zero1:
        opt = convert.opt_state({"t": t, "shard": {
            k: src[f"['opt']/['shard']/['{k}']"]
            for k in ("master", "m", "v")}}, rank)
    else:
        opt = {"t": t, **{k: [model.shard_slice(n, tensor(
            _path("opt", f"{k}.{n}"), m)).clone()
            for n, m in model.named_parameters()] for k in ("m", "v")}}
    agg = []
    for i in range(len(setup.layout.sizes)) if setup.agg_cfg.compressor \
            != "none" else ():
        agg.append({f: src[f"['agg']/[{i}]/.{f}"] for f in ("q", "err")})
    return {"step": int(src["['step']"]), "params": params, "opt": opt,
            "agg": convert.agg_states(setup.agg_cfg.build(), agg, rank)}


def _jax_to_port(d, rank) -> dict:
    """(d): each JAX file restored in the port against the carry."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train import train_step as ts
    _wait(d, "jax_written")
    out = {}
    for case in JAX_FILES:
        _init_mesh(CASES[case][3])
        setup = _setup(case)
        back, cursor = CheckpointManager(
            os.path.join(d, "jax_ckpt", case), setup).restore(1)
        carry = _jax_state(d, case, setup, rank)
        out[case] = {"same": ts.state_digest(back) == ts.state_digest(carry),
                     "cursor": cursor}
    return out


def _logical(setup, state) -> dict:
    """name -> the logical layout of every parameter and AdamW moment,
    gathered (every rank calls it)."""
    from repro_torch import convert
    model, tp = setup.model, setup.tp
    out = {}
    for i, (n, p) in enumerate(model.named_parameters()):
        vals = {"param": p}
        if not setup.zero1:
            vals.update(m=state["opt"]["m"][i], v=state["opt"]["v"][i])
        for k, v in vals.items():
            out[f"{k}/{n}"] = convert.to_logical(
                setup.arch, n, _np(convert.to_global(model, n, v)), tp)
    return out


def _elastic_one(d, case, where, rank) -> dict:
    """(e): ``case``'s step-1 file restored at the current mesh, then step
    2; rank 0 writes the logical arrays."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train import train_step as ts
    setup = _setup(case)
    state, cursor = CheckpointManager(
        os.path.join(d, "port_ckpt", case), setup).restore(1)
    rec = {"tp": setup.tp, "fsdp": list(setup.fsdp_axes), "cursor": cursor,
           "step": state["step"]}
    logical = _logical(setup, state)
    if rank == 0:
        np.savez(os.path.join(d, f"elastic_{case}_{where}.npz"), **logical)
    if setup.zero1:
        shard = state["opt"]["shard"]
        own = ts._zero1_own_slice(setup, setup.layout, ts._zero1_plan(setup),
                                  ts._flat_order(setup, state["params"]))
        rec.update(t=state["opt"]["t"],
                   master_is_params=bool(torch.equal(shard["master"], own)),
                   mv_zero=not (shard["m"].any() or shard["v"].any()),
                   q_abs=[float(st.q.abs().sum()) for st in state["agg"]])
    _, m = ts.make_step(setup)(state, _batch(setup, 1), LR)
    rec["loss"] = m["loss"].item()
    return rec


def _elastic(d, rank) -> dict:
    out = {}
    for case, wheres in ELASTIC.items():
        for where in wheres:
            if where == "one":
                continue
            _init_mesh((1, *where))
            out[f"{case}@{where[0]}x{where[1]}"] = _elastic_one(
                d, case, f"{where[0]}x{where[1]}", rank)
    return out


def _run_torch(d, rank, port, port2):
    import torch.distributed as dist
    rec = {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        rec["resume"] = {case: _resume_case(d, case, rank)
                         for case in CASES}
        dist.barrier()
        if rank == 0:
            _marker(d, "port_written")
        rec["jax_to_port"] = _jax_to_port(d, rank)
        rec["elastic"] = _elastic(d, rank)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port2}",
                                rank=0, world_size=1)
        try:
            for case, wheres in ELASTIC.items():
                if "one" in wheres:
                    rec["elastic"][f"{case}@one"] = _elastic_one(
                        d, case, "one", 0)
        finally:
            dist.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _run_launcher(d, rank, port, port2):
    """``launch.train --tp 2 --ckpt-dir D --ckpt-every 1`` on two ranks,
    twice."""
    from repro_torch.launch import train as launch
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(LAUNCHER_RANKS),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(LAUNCHER_RANKS),
                      MASTER_ADDR="127.0.0.1")
    common = ["--device", "cpu", "--tp", "2", "--batch", "4", "--seq",
              str(SEQ), "--ckpt-dir", os.path.join(d, "launch"),
              "--ckpt-every", "1", "--log-every", "1"]
    for steps, p in (("2", port), ("3", port2)):
        os.environ["MASTER_PORT"] = p
        print(f"=== run {steps}", flush=True)
        launch.main(common + ["--steps", steps])


# ------------------------------------------------------------ the JAX side
def _jax_setup(case, shape):
    """JAX's setup of ``case`` on a mesh of ``shape`` ((data, model) or
    (pod, data, model)), computing in fp32."""
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    from repro.parallel.compat import make_mesh
    from repro.train import train_step as jts
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    setup = jts.build(_arch(jcfgs, case), make_mesh(shape, axes))
    setup.ctx = dataclasses.replace(setup.ctx, compute_dtype=jnp.float32)
    return setup


def _jax_shape(case):
    procs, local, tp = _mesh(CASES[case][3])
    return (local, tp) if procs == 1 else (procs, local, tp)


def _host(x):
    import jax
    import jax.numpy as jnp
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        x = jax.random.key_data(x)
    x = np.asarray(jax.device_get(x))
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _flat(tree) -> dict:
    import jax
    return {"/".join(str(k) for k in path): _host(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run_jax_write(d):
    """(d): JAX's state of each of ``JAX_FILES`` at data 2 x model 2 with
    random moments, master and error feedback: its file and its arrays."""
    import jax

    from repro.checkpoint import checkpoint as jckpt
    from repro.train import train_step as jts
    rng = np.random.default_rng(9)
    for case in JAX_FILES:
        js = _jax_setup(case, _jax_shape(case))
        state = jts.init_state(js, jax.random.key(0))

        def fill(path, x):
            p = "/".join(str(k) for k in path)
            if not re.search(r"\['(m|v|master)'\]|\.err", p):
                return x
            v = rng.standard_normal(x.shape).astype(np.float32)
            return jax.device_put(v.astype(x.dtype), x.sharding)
        state = jax.tree_util.tree_map_with_path(fill, state)
        jckpt.save(os.path.join(d, "jax_ckpt", case), 1, state, cursor=1)
        np.savez(os.path.join(d, f"jax_state_{case}.npz"), **_flat(state))
    _marker(d, "jax_written")
    np.savez(os.path.join(d, "jax_xent.npz"), **_jax_padded_xent(rng))


#: (B, S, padded vocabulary) of the padded cross-entropy check: 7 logical
#: columns padded to 8 at tp 2
PAD_XENT = (2, 3, 8)
PAD_VOCAB = 7


def _jax_padded_xent(rng) -> dict:
    """JAX's ``vocab_parallel_xent`` at ``model 2`` on logits whose padded
    column is large, and the loss of the logical columns alone."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.models import layers as jl
    from repro.parallel.compat import make_mesh, shard_map
    logits = rng.standard_normal(PAD_XENT).astype(np.float32)
    logits[..., PAD_VOCAB:] = 4.0
    labels = rng.integers(0, PAD_VOCAB, PAD_XENT[:2])
    ctx = jl.ShardCtx(tp=2)
    f = shard_map(lambda z: jl.vocab_parallel_xent(
        z, jnp.asarray(labels), ctx, PAD_VOCAB), make_mesh((2,), ("model",)),
        in_specs=(P(None, None, "model"),), out_specs=P())
    real = logits[..., :PAD_VOCAB]
    lse = np.log(np.exp(real.astype(np.float64)).sum(-1))
    gold = np.take_along_axis(real, labels[..., None], -1)[..., 0]
    return {"jax": np.asarray(jax.jit(f)(jnp.asarray(logits))),
            "logical": (lse - gold).astype(np.float32)}


def _run_jax_read(d):
    """(c) and (g): JAX's restore of every port file at its mesh, the
    ZeRO-1 row order, and the two limits of its manager."""
    import jax

    from repro.checkpoint import checkpoint as jckpt
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.checkpoint.manager import abstract_state as jabstract
    from repro.train import train_step as jts
    setups = {case: _jax_setup(case, _jax_shape(case)) for case in CASES}
    like = {case: jabstract(js) for case, js in setups.items()}
    padded = _jax_setup("dense-fsdp", (1, 4))
    more_buckets = _jax_setup("zero1-powersgd", (4, 1))
    _wait(d, "port_written")
    out = {}
    for case, js in setups.items():
        ck = os.path.join(d, "port_ckpt", case)
        got, cursor = jckpt.restore(ck, 1, like[case])
        np.savez(os.path.join(d, f"jax_read_{case}.npz"), **_flat(got))
        out[case] = {"cursor": cursor}
        if case in ROW_ORDER:
            state = jax.device_put(got, js.sharding(js.state_specs))
            filled = jts._fill_zero1_master(js, state,
                                            jts._bucket_layout(js))
            np.save(os.path.join(d, f"jax_master_{case}.npy"),
                    _host(filled["opt"]["shard"]["master"]))
    # (g) the limits of JAX's manager
    state, _ = JManager(os.path.join(d, "port_ckpt", "dense-fsdp"),
                        padded).restore(1)
    flat = _flat(state)
    out["padded"] = {p: {"shape": list(x.shape),
                         "zero": not np.any(x.astype(np.float32))}
                     for p, x in flat.items() if p.startswith("['params']")}
    try:
        JManager(os.path.join(d, "port_ckpt", "zero1-powersgd"),
                 more_buckets).restore(1)
        out["count"] = {"raised": None}
    except AssertionError as e:
        out["count"] = {"raised": "AssertionError", "args": repr(e.args),
                        "buckets": jts._bucket_layout(more_buckets).n_buckets}
    with open(os.path.join(d, "jax_read.json"), "w") as f:
        json.dump(out, f)


def _env(**extra):
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Runs every process; returns (directory, rank records, JAX's
    record, the launcher's log)."""
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("ckpt_sharded"))
    me = os.path.abspath(__file__)
    xla = os.environ.get("XLA_FLAGS", "") \
        + f" --xla_force_host_platform_device_count={RANKS}" \
        + " --xla_backend_optimization_level=0"
    ports = [str(free_port()) for _ in range(4)]
    procs = [subprocess.Popen([sys.executable, me, "torch", d, str(r)]
                              + ports[:2], env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    procs += [subprocess.Popen([sys.executable, me, "launcher", d, str(r)]
                               + ports[2:], env=_env(),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(LAUNCHER_RANKS)]
    procs += [subprocess.Popen([sys.executable, me, "jax", d, part],
                               env=_env(XLA_FLAGS=xla),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for part in JAX_PARTS]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, f"{p.args[2:]} failed:\n{text[-3000:]}"
    recs = []
    for r in range(RANKS):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    with open(os.path.join(d, "jax_read.json")) as f:
        jx = json.load(f)
    return d, recs, jx, logs[RANKS]


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("case", list(CASES))
def test_resume_continues_bit_identically(results, case):
    """Step 2 after a restore of step 1 in a fresh setup: the
    uninterrupted run's loss and state bits on every rank; the restored
    state is the saved one; ``meta.json`` records the writer's mesh."""
    d, recs, _, _ = results
    for r, rec in enumerate(recs):
        got = rec["resume"][case]
        assert got["restored"] and got["same"], (case, r)
        assert got["loss_resumed"] == got["loss"], (case, r)
        assert got["cursor"] == 1
    with open(os.path.join(d, "port_ckpt", case, "step_000000001",
                           "meta.json")) as f:
        layout = json.load(f)["layout"]
    procs, local, tp = _mesh(CASES[case][3])
    fsdp = ["data"] if CASES[case][2]["dp_mode"] == "fsdp" else []
    assert layout == {"world": RANKS, "pod": procs, "data": local,
                      "model": tp, "fsdp_axes": fsdp,
                      "fsdp": 2 if fsdp else 1, "tp": tp}


# ------------------------------------------------------------------ (c)
@pytest.mark.parametrize("case", list(CASES))
def test_jax_restores_every_port_file_bit_for_bit(results, case):
    """JAX's ``ckpt.restore`` against its own ``abstract_state`` at the
    same mesh: every leaf, per-rank rows included, has the bits of the
    port's tree gathered with other collectives."""
    d, _, jx, _ = results
    assert jx[case]["cursor"] == 1
    port = np.load(os.path.join(d, f"port_{case}.npz"))
    got = np.load(os.path.join(d, f"jax_read_{case}.npz"))
    assert sorted(port.files) == sorted(got.files)
    for k in port.files:
        assert port[k].shape == got[k].shape, k
        np.testing.assert_array_equal(port[k].astype(got[k].dtype), got[k],
                                      err_msg=k)


@pytest.mark.parametrize("case", ROW_ORDER)
def test_per_rank_rows_are_jax_device_order(results, case):
    """Row ``i`` of a per-rank leaf is JAX's device ``i`` of the ``(pod,
    data, model)`` mesh: JAX's ``_fill_zero1_master`` of the restored
    parameters (each device's owned slice of its model shard) is the
    port's master rounded to bf16, row by row (data 2 x model 2 and pod
    2 x data 1 x model 2)."""
    import ml_dtypes
    d, _, _, _ = results
    port = np.load(os.path.join(d, f"port_{case}.npz"))[
        "['opt']/['shard']/['master']"]
    want = np.load(os.path.join(d, f"jax_master_{case}.npy"))
    assert port.shape == want.shape and port.shape[0] == RANKS
    rounded = port.astype(ml_dtypes.bfloat16).astype(np.float32)
    for i in range(RANKS):
        np.testing.assert_array_equal(rounded[i], want[i], err_msg=f"row {i}")
    assert not np.array_equal(want[0], want[1])     # the model shards differ


# ------------------------------------------------------------------ (d)
@pytest.mark.parametrize("case", JAX_FILES)
def test_jax_file_restores_as_the_convert_carry(results, case):
    _, recs, _, _ = results
    for r, rec in enumerate(recs):
        got = rec["jax_to_port"][case]
        assert got["same"] and got["cursor"] == 1, (case, r)


# ------------------------------------------------------------------ (e)
def _elastic_cases():
    return [f"{case}@{w if w == 'one' else f'{w[0]}x{w[1]}'}"
            for case, wheres in ELASTIC.items() for w in wheres]


@pytest.mark.parametrize("key", _elastic_cases())
def test_elastic_restore_keeps_the_logical_state(results, key):
    """The file of ``data 2 x model 2`` at another FSDP degree or ``tp``:
    the logical parameters and AdamW moments bit-equal to the writer's,
    the next loss within ``ELASTIC_RTOL`` of the writer's layout's, the
    cursor and step kept; under ZeRO-1 ``agg`` rebuilt (PowerSGD ``q``
    not zero), the master the restored parameters, ``m`` and ``v`` zero,
    ``t`` kept."""
    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    d, recs, _, _ = results
    case, where = key.split("@")
    cfg = _arch(tcfgs, case)
    src = np.load(os.path.join(d, f"port_{case}.npz"))
    got = np.load(os.path.join(d, f"elastic_{case}_{where}.npz"))
    zero1 = CASES[case][2]["zero1"]
    n = 0
    for k in got.files:
        kind, name = k.split("/", 1)
        top = {"param": "params", "m": "opt", "v": "opt"}[kind]
        path = _path(top, name if kind == "param" else f"{kind}.{name}")
        want = convert.to_logical(cfg, name, src[path], 2)
        np.testing.assert_array_equal(got[k], want, err_msg=f"{key} {k}")
        n += 1
    assert n == (1 if zero1 else 3) * len(
        [f for f in src.files if f.startswith("['params']")])
    ranks = recs[:1] if where == "one" else recs
    for r, rec in enumerate(ranks):
        e = rec["elastic"][key]
        want_loss = rec["resume"][case]["loss"] if where != "one" \
            else recs[0]["resume"][case]["loss"]
        assert abs(e["loss"] / want_loss - 1) <= ELASTIC_RTOL, (key, r, e)
        assert (e["step"], e["cursor"]) == (1, 1)
        if zero1:
            assert e["t"] == 1 and e["master_is_params"] and e["mv_zero"]
            # a data axis of one rank compresses nothing: no agg there
            compressed = where != "one" and int(where.split("x")[0]) > 1
            assert bool(e["q_abs"]) == compressed, (key, e)
            assert all(q > 0 for q in e["q_abs"]), (key, e)
    if where != "one":
        tp = int(where.split("x")[1])
        assert all(rec["elastic"][key]["tp"] == tp for rec in recs)


# ------------------------------------------------------------------ (f)
def test_launcher_saves_and_resumes_under_tp(results):
    from repro_torch.checkpoint import checkpoint as ckpt
    d, _, _, log = results
    first, second = log.split("=== run 3")
    assert "tp=2" in first
    assert re.findall(r"^step +(\d+)", first, re.M) == ["1", "2"]
    assert re.findall(r"^step +(\d+)", second, re.M) == ["3"]
    assert "[train] done at step 3" in second
    assert ckpt.list_steps(os.path.join(d, "launch")) == [1, 2, 3]
    assert ckpt.read_meta(os.path.join(d, "launch"), 3)["layout"]["tp"] == 2


# ------------------------------------------------------------------ (g)
def test_reference_restore_at_another_tp_zeroes_padded_leaves(results):
    """A limit of the reference that the port does not copy: JAX's
    manager restores the FSDP x TP file of ``model 2`` at ``model 4``
    with every leaf whose padded shape changed (the vocabulary tables,
    ``wq`` and ``wo`` of the 6 q heads now padded to 8) as zeros, the
    other leaves as saved (the port re-lays them out:
    ``test_elastic_restore_keeps_the_logical_state``)."""
    _, _, jx, _ = results
    padded = jx["padded"]
    changed = {"['params']/['embed']/['table']",
               "['params']/['unembed']/['table']",
               "['params']/['blocks']/['attn']/['wq']/['w']",
               "['params']/['blocks']/['attn']/['wo']/['w']"}
    assert changed <= set(padded)
    for p, rec in padded.items():
        assert rec["zero"] == (p in changed), (p, rec)


def test_reference_padded_vocabulary_enters_the_softmax(results):
    """A limit of the reference that the port does not copy: JAX's
    vocabulary-parallel cross-entropy counts the padded columns in its
    log-sum-exp (its padded rows are drawn at init and trained), so its
    loss at a ``tp`` that pads the vocabulary is not the logical
    vocabulary's.  The port masks them (``layers.vocab_parallel_xent``),
    so a restore at another ``tp`` keeps the loss
    (``test_elastic_restore_keeps_the_logical_state``)."""
    d, _, _, _ = results
    x = np.load(os.path.join(d, "jax_xent.npz"))
    assert x["jax"].shape == x["logical"].shape == PAD_XENT[:2]
    assert (x["jax"] - x["logical"]).min() > 0.1


def test_reference_bucket_count_change_stops_at_the_leaf_count(results):
    """Another limit of the reference: the ZeRO-1 PowerSGD file of
    ``data 2 x model 2`` has one compressor state per bucket of the 1/tp
    shard; at ``data 4`` JAX's layout has more buckets, and its restore
    stops at its leaf-count assertion (the port rebuilds ``agg``:
    ``test_elastic_restore_keeps_the_logical_state``)."""
    _, recs, jx, _ = results
    assert jx["count"]["raised"] == "AssertionError", jx["count"]
    e = recs[0]["elastic"]["zero1-powersgd@4x1"]
    assert len(e["q_abs"]) == jx["count"]["buckets"]


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        {"write": _run_jax_write, "read": _run_jax_read}[sys.argv[3]](
            sys.argv[2])
    elif sys.argv[1] == "torch":
        _run_torch(sys.argv[2], int(sys.argv[3]), *sys.argv[4:])
    else:
        _run_launcher(sys.argv[2], int(sys.argv[3]), *sys.argv[4:])
