"""The audio family's DDP step: the port (``repro_torch.train``) against the
JAX package's on four ranks, and the pieces of the step the audio family
adds.

* Four ranks: JAX ``make_step`` on 4 fake CPU devices in one subprocess,
  the port on 4 gloo processes, all started together; each runs every
  case below, ``STEPS`` steps of the reduced ``seamless-m4t-medium`` (2
  encoder and 2 decoder blocks, d_model 128, vocab 512) on
  ``dp_mode="ddp"`` at lr 1e-3, 24 decoder tokens over 24 frames, from
  the same parameters (drawn here with numpy; bf16 values under ZeRO-1),
  the same per-rank batches (``tokens``, ``labels`` and seeded fp32
  ``enc_embeds``) and the PowerSGD warm starts JAX's ``init_state``
  draws: the classic fp32 step with PowerSGD; ZeRO-1 with PowerSGD,
  computing in fp32 and once in bf16; the overlapped ZeRO-1 step with
  PowerSGD and ``remat="full"`` (two stacks: the decoder's stages, then
  the encoder's); and the overlapped ZeRO-1 step uncompressed at
  ``accum=2``.  The port runs the overlapped PowerSGD case under
  ``overlap`` and ``serial``, which must give the same bits on every rank
  (parameters, ZeRO-1 shards, compressor states, metrics).
* The overlapped layout of the reduced and the full arch (bucket sizes,
  ``bucket_ready``, stacks) equals JAX's ``build_layout``.
* ``train_step._to_device`` keeps ``enc_embeds`` fp32 and makes the token
  arrays int64.

The fp32 cases compute in fp32 on both sides, for the reason
``tests/test_torch_zero1.py`` gives, and the JAX process runs with
``--xla_allow_excess_precision=false``, as ``tests/test_torch_hybrid_step.py``
does, so that XLA rounds each bf16 value where the program does.

Tolerances are ``tests/test_torch_ssm_step.py``'s: loss ``rtol=1e-3``;
grad norm ``rtol=1e-2``; parameters and each rank's fp32 master shard:
max difference at most ``2 * lr * steps + 1e-4``, at most 2% of elements
beyond ``lr / 2`` (for each leaf of at least ``SMALL_LEAF`` elements and
for the smaller leaves pooled), median at most ``lr / 50``; each rank's
m and v within a relative L2 difference of 1e-2 after the first step and
of ``MV_DRIFT`` (5e-2) after the last; ``t`` equal.  The bf16 case holds
m and v to ``MV_DRIFT`` after the first step too: bf16 gradients differ
by 1-1.5% per leaf between the packages (``tests/test_torch_zero1.py``).
Measured: losses within 3e-5, grad norms within 4e-4, m and v within
0.03-0.6% in fp32 and 0.8-0.9% in bf16.

This file is also the subprocess script: ``python test_torch_audio_step.py
jax DIR`` or ``python test_torch_audio_step.py torch DIR RANK PORT``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(ROOT)
ARCH = "seamless-m4t-medium"
RANKS = 4
LR = 1e-3
STEPS = 2
GLOBAL_BATCH = 8             # 2 rows per rank
SEQ = 24
BUCKET_MB = 0.125
TIMEOUT_S = 300
#: parameter leaves smaller than this are held to the 2% share rule as
#: one pool, not one by one
SMALL_LEAF = 2048
#: m and v after the last step (and, in the bf16 case, the first): the
#: largest relative L2 difference from JAX's
MV_DRIFT = 5e-2

#: case -> (plan overrides beside dp_mode="ddp", compute dtype, accum)
CASES = {
    "a-classic-powersgd": (dict(zero1=False, compression="powersgd"),
                           "float32", 1),
    "b-zero1-powersgd": (dict(zero1=True, compression="powersgd"),
                         "float32", 1),
    "c-zero1-powersgd-bf16": (dict(zero1=True, compression="powersgd"),
                              "bfloat16", 1),
    "d-overlap-powersgd": (dict(zero1=True, overlap=True, remat="full",
                                compression="powersgd"), "float32", 1),
    "e-overlap-accum2": (dict(zero1=True, overlap=True, remat="full"),
                         "float32", 2),
}


def _schedule(case):
    return "overlap" if CASES[case][0].get("overlap") else "classic"


#: the port's runs: (case, schedule)
RUNS = [(c, _schedule(c)) for c in CASES] + [("d-overlap-powersgd", "serial")]


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
    ov = CASES[case][0]
    model = Model(_reduced(tcfgs), ShardCtx(
        param_dtype=torch.bfloat16 if ov["zero1"] else torch.float32),
        device="meta")
    if ov.get("overlap"):
        return overlap.layout_for_model(model, BUCKET_MB).layout.sizes
    return bucketing.layout_for(list(model.parameters()), BUCKET_MB).sizes


# ------------------------------------------------------------ the inputs
def _make_inputs(d):
    """in.npz: the start parameters (bf16 values, held in fp32), the
    batches and, per PowerSGD case, the warm starts
    (``q/<case>/<bucket>``) JAX's ``init_state`` draws."""
    import jax

    from repro.configs import base as jcfgs
    from repro.core.compression import base as jbase
    from repro.data.synthetic import DataConfig, batch_at
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_layout
    rng = np.random.default_rng(23)
    arrays = {}
    cfg = _reduced(tcfgs)
    for name, shape, init in param_layout(cfg):
        value = np.ones(shape) if init is None \
            else init * np.clip(rng.standard_normal(shape), -3, 3)
        arrays[f"param/{name}"] = np.asarray(
            jax.numpy.asarray(value, jax.numpy.bfloat16), np.float32)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=GLOBAL_BATCH)
    for s in range(STEPS):
        for k, v in batch_at(dcfg, s).items():
            arrays[f"{k}/{s}"] = v
        arrays[f"enc_embeds/{s}"] = rng.standard_normal(
            (GLOBAL_BATCH, SEQ, cfg.d_model)).astype(np.float32)
    for case, (ov, _, _) in CASES.items():
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
    b = {k: inp[f"{k}/{step}"] for k in ("tokens", "labels", "enc_embeds")}
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
    for case, (ov, compute, accum) in CASES.items():
        setup = jts.build(_reduced(jcfgs), mesh, dp_mode="ddp",
                          bucket_mb=BUCKET_MB, **ov)
        setup.ctx = dataclasses.replace(setup.ctx,
                                        compute_dtype=jnp.dtype(compute))
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
        step = jts.make_step(setup, accum=accum)(_batch(inp, 0))
        for s in range(STEPS):
            state, m = step(state, _batch(inp, s), jnp.float32(LR))
            m = jax.device_get(m)
            for k in ("loss", "grad_norm"):
                out[f"{k}/{s}"] = m[k]
            if setup.zero1 and s == 0:
                shard = jax.device_get(state["opt"]["shard"])
                for k in ("m", "v"):
                    out[f"shard1/{k}"] = np.asarray(shard[k])
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
    ov, compute, accum = CASES[case]
    setup = tts.build(_reduced(tcfgs), "cpu", dp_mode="ddp",
                      bucket_mb=BUCKET_MB, **ov)
    setup.model.ctx = dataclasses.replace(
        setup.model.ctx, compute_dtype=getattr(torch, compute))
    state = tts.init_state(setup)
    convert.load_params(setup.model, _nest(_start_params(inp)))
    if setup.zero1:
        state = tts._fill_zero1_master(setup, state)
    if state["agg"]:
        state["agg"] = convert.agg_states(
            setup.agg_cfg.build(),
            [{"q": inp[f"q/{case}/{i}"], "err": np.zeros(n, np.float32)}
             for i, n in enumerate(setup.layout.sizes)], index=None)
    step = overlap.make_step(setup, schedule, accum) \
        if schedule != "classic" else tts.make_step(setup, accum)
    out = {}
    for s in range(STEPS):
        state, m = step(state, _batch(inp, s, rank), LR)
        for k in ("loss", "grad_norm", "moe_aux", "tokens"):
            out[f"{k}/{s}"] = m[k].item()
            out[f"bits/{k}/{s}"] = _bits(m[k])
        if setup.zero1 and s == 0:
            for k in ("m", "v"):
                out[f"shard1/{k}"] = state["opt"]["shard"][k].numpy().copy()
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
    if schedule != "classic":
        out["flush_order"] = np.asarray(step.flush_order)
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


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Runs every case on both sides; returns the directory."""
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("audio_step"))
    _make_inputs(d)
    me = os.path.abspath(__file__)
    xla = os.environ.get("XLA_FLAGS", "") \
        + f" --xla_force_host_platform_device_count={RANKS}" \
        + " --xla_allow_excess_precision=false"
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


def _ports(d, case, schedule=None):
    schedule = schedule or _schedule(case)
    return [_load(d, f"torch_{case}_{schedule}_{r}") for r in range(RANKS)]


def _assert_close_to_lr(got, want, what, share=True):
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * STEPS + 1e-4, (what, diff.max())
    if share:
        assert (diff > LR / 2).mean() <= 0.02, (what,
                                                 (diff > LR / 2).mean())
    assert np.median(diff) <= LR / 50, (what, np.median(diff))


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_audio_step_matches_jax_on_four_ranks(results, case):
    d = results
    jx = _load(d, f"jax_{case}")
    bf16 = CASES[case][1] == "bfloat16"
    for r, pt in enumerate(_ports(d, case)):
        for s in range(STEPS):
            assert pt[f"tokens/{s}"] == GLOBAL_BATCH * SEQ
            np.testing.assert_allclose(pt[f"loss/{s}"], jx[f"loss/{s}"],
                                       rtol=1e-3, err_msg=f"loss {s}")
            np.testing.assert_allclose(pt[f"grad_norm/{s}"],
                                       jx[f"grad_norm/{s}"], rtol=1e-2,
                                       err_msg=f"grad norm {s}")
            assert pt[f"moe_aux/{s}"] == 0.0
        names = [k for k in jx.files if k.startswith("param/")]
        assert sorted(names) == sorted(k for k in pt.files
                                       if k.startswith("param/"))
        small = []
        for k in names:
            name = k.split("/", 1)[1]
            assert str(pt[f"dtype/{name}"]) == str(jx[f"dtype/{name}"])
            _assert_close_to_lr(pt[k], jx[k], f"{k} rank {r}",
                                share=jx[k].size >= SMALL_LEAF)
            if jx[k].size < SMALL_LEAF:
                small.append((pt[k].ravel(), jx[k].ravel()))
        _assert_close_to_lr(*(np.concatenate(x) for x in zip(*small)),
                            f"the leaves under {SMALL_LEAF} elements rank "
                            f"{r}")
        if "t" not in jx.files:
            continue
        assert int(pt["t"]) == int(jx["t"]) == STEPS
        _assert_close_to_lr(pt["shard/master"], jx["shard/master"][r],
                            f"master rank {r}")
        for k in ("m", "v"):
            rel = _rel(pt[f"shard1/{k}"], jx[f"shard1/{k}"][r])
            assert rel <= (MV_DRIFT if bf16 else 1e-2), (k, "step 1", r, rel)
            rel = _rel(pt[f"shard/{k}"], jx[f"shard/{k}"][r])
            assert rel <= MV_DRIFT, (k, r, rel)


def test_audio_ranks_agree_and_every_leaf_trains(results):
    """Every rank ends with the same parameters, and every leaf moved
    (its gradient was live)."""
    d = results
    start = _start_params(np.load(os.path.join(d, "in.npz")))
    for case in CASES:
        ports = _ports(d, case)
        for k in (k for k in ports[0].files if k.startswith("param/")):
            for pt in ports[1:]:
                np.testing.assert_array_equal(pt[k], ports[0][k], err_msg=k)
            assert not np.array_equal(ports[0][k],
                                      start[k.split("/", 1)[1]]), (case, k)


def test_serial_and_overlap_give_the_same_bits(results):
    ov, se = (_ports(results, "d-overlap-powersgd", s)
              for s in ("overlap", "serial"))
    for a, b in zip(ov, se):
        bits = [k for k in a.files if k.startswith("bits/")]
        assert bits == [k for k in b.files if k.startswith("bits/")]
        assert any(k.startswith("bits/agg/") for k in bits)
        assert any(k.startswith("bits/shard/") for k in bits)
        for k in bits:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_overlap_flushes_the_decoder_then_the_encoder(results):
    """Each bucket is issued after the stage that completes it: the
    decoder's blocks are stages 0-1, the encoder's 2-3, the tail 4."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import overlap
    ov = overlap.layout_for_model(Model(
        _reduced(tcfgs), ShardCtx(param_dtype=torch.bfloat16),
        device="meta"), BUCKET_MB)
    assert [(s.key, s.n_layers, s.stage0) for s in ov.stacks] == [
        ("dec_blocks", 2, 0), ("enc_blocks", 2, 2)]
    for pt in _ports(results, "d-overlap-powersgd"):
        assert [tuple(x) for x in pt["flush_order"]] == \
            list(enumerate(ov.bucket_ready))
    assert set(ov.bucket_ready) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_overlap_layout_matches_jax(full):
    """JAX's ``overlap.build_layout`` against the port's: the reduced arch
    at ``BUCKET_MB`` and the full one at its 25 MB, ZeRO-1 (bf16)."""
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
    jarch, tarch = jcfgs.get(ARCH), tcfgs.get(ARCH)
    if not full:
        jarch, tarch = _reduced(jcfgs), _reduced(tcfgs)
    want = jov.build_layout(jts.build(jarch, make_local_mesh(),
                                      bucket_mb=bucket_mb, overlap=True))
    got = tov.layout_for_model(Model(tarch, ShardCtx(
        param_dtype=torch.bfloat16), device="meta"), bucket_mb)
    assert str(got.layout.dtype).removeprefix("torch.") == \
        str(want.layout.dtype) == "bfloat16"
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
        assert got.n_stages == 24 and got.bucket_ready[-1] == 24
        assert got.layout.n_elements == 877_094_912


def test_to_device_keeps_enc_embeds_fp32():
    import torch

    from repro_torch.train import train_step as tts
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
             "labels": np.arange(6, dtype=np.int32).reshape(2, 3),
             "enc_embeds": np.full((2, 3, 4), 0.25, np.float32)}
    out = tts._to_device(batch, torch.device("cpu"))
    assert out["tokens"].dtype == out["labels"].dtype == torch.int64
    assert out["enc_embeds"].dtype == torch.float32
    assert torch.equal(out["enc_embeds"], torch.full((2, 3, 4), 0.25))


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), sys.argv[4])
