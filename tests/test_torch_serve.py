"""Serving in the port (prefill, one-token decode with a KV cache, the
Engine and ``launch/serve.py``) against the JAX package, on one rank.

The JAX package runs in one subprocess at XLA's optimisation level 0
(``python test_torch_serve.py jax DIR``), started by the module fixture
while the port's tests run here; both read the same numpy inputs
(``in.npz``: per arch the global fp32 parameters drawn with numpy, the
tokens, the vlm ``embeds`` and M-RoPE positions, the attention and cache
inputs).

* ``decode_attention`` with GQA, a per-row ``cur_len`` and cache
  positions that start at an offset; the cache writes of prefill and of
  decode (one row's slot past the cache, dropped in both), on the valid
  slots.
* ``Model.prefill`` and ``STEPS`` ``Model.decode`` steps of the reduced
  ``tinyllama-1.1b``, ``qwen3-32b`` (qk-norm), ``qwen2-vl-7b`` (``embeds``
  and M-RoPE) and ``qwen2-moe-a2.7b``, weights carried by ``convert``: in
  fp32 (parameters, compute and caches) within ``2e-5 * max(1,
  max|JAX|)``; in bf16 (parameters, compute and JAX's bf16 caches) within
  JAX's own ``rtol = atol = 2e-2`` (``tests/test_models_smoke.py``).
* The port's prefill -> decode consistency per family: a decode step's
  logits against a fresh prefill over the same tokens, bf16 compute,
  ``rtol = atol = 2e-2`` as JAX's own test, the MoE capacity factor at 8
  so that no pick is dropped in either.
* ``Engine.generate`` against JAX's ``Engine`` on the reduced
  tinyllama with carried weights, fp32 compute and fp32 caches on both
  sides, on the prompts of ``tests/test_system.py``: the same tokens, with
  the ``max_new``, EOS and ``cache_len`` stops.
* ``python -m repro_torch.launch.serve --device cpu`` prints one line per
  prompt; the hybrid, ssm and audio families raise
  ``NotImplementedError``; the Engine refuses a vlm arch.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_tp_step import _env, _nest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE, QK, VLM, MOE = ("tinyllama-1.1b", "qwen3-32b", "qwen2-vl-7b",
                       "qwen2-moe-a2.7b")
ARCHS = (DENSE, QK, VLM, MOE)
B, S, CAP, STEPS = 2, 8, 16, 3
FP32_RTOL = 2e-5
BF16_TOL = 2e-2
TIMEOUT_S = 300
#: the attention check: (B, H, KVh, hd, Sc), the cache's first position
ATTN = (3, 4, 2, 8, 10)
ATTN_OFFSET = 5
ATTN_CUR = (7, 12, 15)
#: the Engine cases: case -> (cache_len, eos from the greedy run or -1)
ENGINE = {"greedy": (64, False), "eos": (64, True), "cache_len": (6, False)}
PROMPTS = ([1, 2, 3], [5])
MAX_NEW = (4, 7)


def _reduced(cfgs, name, **kw):
    return cfgs.reduced(cfgs.get(name), **kw)


def _make_inputs(d):
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import param_layout
    rng = np.random.default_rng(29)
    arrays = {}
    for name in ARCHS:
        cfg = _reduced(tcfgs, name)
        for leaf, shape, init in param_layout(cfg):
            arrays[f"param/{name}/{leaf}"] = (
                np.ones(shape) if init is None
                else init * np.clip(rng.standard_normal(shape), -3, 3)
            ).astype(np.float32)
        arrays[f"tokens/{name}"] = rng.integers(
            0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
        if cfg.family == "vlm":
            arrays["embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
            arrays["mrope"] = rng.integers(
                0, 24, (3, B, S + STEPS)).astype(np.int32)
    b, h, kvh, hd, sc = ATTN
    for k, shape in (("q", (b, 1, h, hd)), ("k", (b, sc, kvh, hd)),
                     ("v", (b, sc, kvh, hd)), ("wk", (b, S, kvh, hd)),
                     ("wv", (b, S, kvh, hd)), ("dk", (b, 1, kvh, hd)),
                     ("dv", (b, 1, kvh, hd))):
        arrays[f"attn/{k}"] = rng.standard_normal(shape).astype(np.float32)
    np.savez(os.path.join(d, "in.npz"), **arrays)


def _params(inp, name):
    pre = f"param/{name}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def _prefill_batch(inp, name):
    if name == VLM:
        return {"embeds": inp["embeds"],
                "mrope_positions": inp["mrope"][..., :S]}
    return {"tokens": inp[f"tokens/{name}"][:, :S]}


def _decode_batch(inp, name, i):
    out = {"tokens": inp[f"tokens/{name}"][:, S + i:S + i + 1],
           "cur_len": np.full((B,), S + i, np.int32)}
    if name == VLM:
        out["mrope_positions"] = inp["mrope"][..., S + i:S + i + 1]
    return out


# ------------------------------------------------------------- JAX side
def _run_jax(d):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    from repro.configs.shapes import ShapeConfig
    from repro.launch.mesh import make_local_mesh
    from repro.models import Model
    from repro.models import attention as jattn
    from repro.models import transformer as jtf
    from repro.models.layers import ShardCtx
    from repro.serving import serve_step as ss
    from repro.serving.engine import Engine, Request
    inp = np.load(os.path.join(d, "in.npz"))
    out = {}
    a = {k: jnp.asarray(inp[f"attn/{k}"]) for k in
         ("q", "k", "v", "wk", "wv", "dk", "dv")}
    b, _, _, _, sc = ATTN
    pos = jnp.broadcast_to(jnp.arange(sc) + ATTN_OFFSET, (b, sc))
    out["attn"] = np.asarray(jattn.decode_attention(
        a["q"], a["k"], a["v"], jnp.asarray(ATTN_CUR), cache_positions=pos))
    cache = {"k": jnp.zeros_like(a["k"]), "v": jnp.zeros_like(a["v"])}
    cache = jtf._cache_write(cache, a["wk"], a["wv"],
                             jtf.StepState("prefill"), ShardCtx(), None)
    cur = jnp.asarray([S, sc + 2, S + 1])
    cache = jtf._cache_write(cache, a["dk"], a["dv"],
                             jtf.StepState("decode", cur_len=cur),
                             ShardCtx(), cur[:, None])
    out["cache_k"], out["cache_v"] = (np.asarray(cache[k]) for k in "kv")

    def run(name, dt):
        cfg = _reduced(jcfgs, name)
        m = Model(cfg)
        ctx = ShardCtx(param_dtype=dt, compute_dtype=dt)
        fp32 = ("router", "shared_gate")
        flat = {k: v.astype(np.float32 if k.endswith(fp32) else dt)
                for k, v in _params(inp, name).items()}
        params = jax.tree.map(jnp.asarray, _nest(flat))
        sds, _ = m.cache_shape(ctx, B, CAP)
        # the cache in the run's dtype (JAX's own is bf16 at any dtype)
        cache = jax.tree.map(lambda s: jnp.zeros(s.shape, dt), sds,
                             is_leaf=lambda x: isinstance(
                                 x, jax.ShapeDtypeStruct))
        batch = jax.tree.map(jnp.asarray, _prefill_batch(inp, name))
        logits, cache = jax.jit(m.prefill, static_argnums=2)(
            params, batch, ctx, cache)
        got = [logits]
        dec = jax.jit(m.decode, static_argnums=3)
        for i in range(STEPS):
            logits, cache = dec(params, cache, jax.tree.map(
                jnp.asarray, _decode_batch(inp, name, i)), ctx)
            got.append(logits)
        return [np.asarray(x.astype(jnp.float32)) for x in got], cache

    for name in ARCHS:
        for tag, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
            logits, cache = run(name, dt)
            for i, x in enumerate(logits):
                out[f"logits/{name}/{tag}/{i}"] = x
            if tag == "fp32":
                out[f"kv/{name}"] = np.asarray(cache["k"])

    cfg = _reduced(jcfgs, DENSE)
    flat = _params(inp, DENSE)
    eos = -1
    for case, (cache_len, use_eos) in ENGINE.items():
        setup = ss.build_serve(cfg, make_local_mesh(), ShapeConfig(
            "t", "decode", seq_len=cache_len, global_batch=2),
            param_dtype=jnp.float32)
        setup = dataclasses.replace(
            setup, ctx=dataclasses.replace(setup.ctx,
                                           compute_dtype=jnp.float32),
            cache_sds_local=jax.tree.map(
                lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                setup.cache_sds_local,
                is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
        params = jax.device_put(jax.tree.map(jnp.asarray, _nest(flat)),
                                setup.sharding(setup.param_specs))
        eng = Engine(setup, params, eos_id=eos if use_eos else -1)
        done = eng.generate([Request(i, list(p), max_new=n) for i, (p, n)
                             in enumerate(zip(PROMPTS, MAX_NEW))])
        for r in done:
            out[f"engine/{case}/{r.rid}"] = np.asarray(r.out, np.int64)
        if case == "greedy":
            eos = done[1].out[2]
            out["engine/eos_id"] = np.asarray(eos)
    np.savez(os.path.join(d, "jax.npz"), **out)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Writes the inputs and starts the JAX process; yields (dir, the
    process), which ``jax`` waits for."""
    d = str(tmp_path_factory.mktemp("serve"))
    _make_inputs(d)
    xla = os.environ.get("XLA_FLAGS", "") \
        + " --xla_backend_optimization_level=0"
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "jax", d], env=_env(XLA_FLAGS=xla),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        yield d, proc
    finally:
        proc.kill()


@pytest.fixture(scope="module")
def jax_out(work):
    d, proc = work
    log = proc.communicate(timeout=TIMEOUT_S)[0]
    assert proc.returncode == 0, f"the JAX process failed:\n{log[-3000:]}"
    return np.load(os.path.join(d, "jax.npz"))


@pytest.fixture(scope="module")
def inp(work):
    return np.load(os.path.join(work[0], "in.npz"))


@pytest.fixture
def own_world():
    """A one-rank process group that ``build_serve`` joins is left as the
    test found it: destroyed after the test when it made one."""
    import torch.distributed as dist
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


def _t(a):
    import torch
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ the tests
# ---- the port alone first, while the JAX process runs
@pytest.mark.usefixtures("work")
@pytest.mark.parametrize("name", (DENSE, VLM, MOE))
def test_prefill_then_decode_equals_a_longer_prefill(name):
    """One decode step after a prefill of S tokens gives the logits of a
    fresh prefill over the S + 1 tokens (bf16 compute; the vlm family's
    token at S enters as its table row, as JAX's test feeds it)."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    cfg = _reduced(tcfgs, name)
    if cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    model = Model(cfg, ShardCtx(), device="cpu")
    model.init_params(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    s = 16
    toks = torch.randint(0, cfg.vocab, (B, s + 1), generator=gen)
    dec = {"tokens": toks[:, s:], "cur_len": torch.full((B,), s)}
    if name == VLM:
        emb = torch.randn(B, s, cfg.d_model, generator=gen)
        mrope = torch.randint(0, 24, (3, B, s + 1), generator=gen)
        first = {"embeds": emb, "mrope_positions": mrope[..., :s]}
        row = model.embed.table.detach()[toks[:, s]][:, None].float()
        whole = {"embeds": torch.cat([emb, row], 1), "mrope_positions": mrope}
        dec["mrope_positions"] = mrope[..., s:]
    else:
        first, whole = {"tokens": toks[:, :s]}, {"tokens": toks}
    _, cache = model.prefill(first, model.new_cache(B, 24))
    got, _ = model.decode(cache, dec)
    want, _ = model.prefill(whole, model.new_cache(B, 24))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_temperature_sampling_repeats_with_its_seed(inp, own_world):
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.serving import serve_step as ss
    from repro_torch.serving.engine import Engine, Request
    setup = ss.build_serve(_reduced(tcfgs, DENSE), ShapeConfig(
        "t", "decode", seq_len=32, global_batch=2), device="cpu")
    ss.serve_params(setup, torch.Generator().manual_seed(0))
    outs = []
    for seed in (5, 5, 6):
        eng = Engine(setup, temperature=1.0, seed=seed)
        outs.append([r.out for r in eng.generate(
            [Request(0, [1, 2, 3], max_new=8)])])
    assert outs[0] == outs[1] and outs[0] != outs[2]


@pytest.mark.usefixtures("work")
def test_launcher_prints_one_line_per_prompt():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--max-new", "4", "--prompts", "1 2 3", "7 8", "9"],
        env=_env(OMP_NUM_THREADS="2"), capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [x for x in out.stdout.splitlines() if x.startswith("[serve]")]
    assert len(lines) == 3, out.stdout
    assert lines[0].startswith("[serve] req 0: prompt=[1, 2, 3] -> [")
    assert all(len(x.split("-> [")[1].split(",")) == 4 for x in lines)


@pytest.mark.parametrize("name", ("zamba2-2.7b", "xlstm-350m",
                                  "seamless-m4t-medium"))
def test_unported_serving_families_raise(name, own_world):
    from repro_torch.configs import base as tcfgs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.serving import serve_step as ss
    cfg = _reduced(tcfgs, name)
    with pytest.raises(NotImplementedError, match="next serving slice"):
        ss.build_serve(cfg, ShapeConfig("t", "decode", 16, 1), device="cpu")
    model = Model(cfg, ShardCtx(), device="meta")
    for call in (lambda: model.cache_shape(1, 16),
                 lambda: model.prefill({}, {}),
                 lambda: model.decode({}, {})):
        with pytest.raises(NotImplementedError, match=cfg.family):
            call()


def test_engine_refuses_a_vlm_arch(own_world):
    from repro_torch.configs import base as tcfgs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.serving import serve_step as ss
    from repro_torch.serving.engine import Engine
    setup = ss.build_serve(_reduced(tcfgs, VLM), ShapeConfig(
        "t", "decode", 16, 1), device="cpu")
    with pytest.raises(ValueError, match="mrope_positions"):
        Engine(setup)


# ---- against the JAX process's results
def test_decode_attention_matches_jax(inp, jax_out):
    import torch

    from repro_torch.models.attention import decode_attention
    a = {k: _t(inp[f"attn/{k}"]) for k in ("q", "k", "v")}
    b, _, _, _, sc = ATTN
    pos = (torch.arange(sc) + ATTN_OFFSET).expand(b, sc)
    got = decode_attention(a["q"], a["k"], a["v"], torch.tensor(ATTN_CUR),
                           pos).numpy()
    want = jax_out["attn"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FP32_RTOL * max(1, np.abs(want).max()))


def test_cache_writes_match_jax_on_valid_slots(inp, jax_out):
    """Prefill at 0..S-1, then one decode token per row at its
    ``cur_len`` (S, past the cache, S + 1): the slots below each row's
    ``cur_len + 1`` equal JAX's, and the row past the cache is dropped."""
    import torch

    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.transformer import StepState, cache_write
    a = {k: _t(inp[f"attn/{k}"]) for k in ("k", "wk", "wv", "dk", "dv")}
    cache = {"k": torch.zeros_like(a["k"]), "v": torch.zeros_like(a["k"])}
    cache_write(cache, a["wk"], a["wv"], StepState("prefill"), ShardCtx())
    sc = ATTN[-1]
    cur = torch.tensor([S, sc + 2, S + 1])
    cache_write(cache, a["dk"], a["dv"], StepState("decode", cur),
                ShardCtx())
    for k in "kv":
        got, want = cache[k].numpy(), jax_out[f"cache_{k}"]
        for row, n in enumerate(cur.tolist()):
            n = min(n + 1, sc)
            np.testing.assert_array_equal(got[row, :n], want[row, :n])
    assert not cache["k"][1, S:].any(), "the write past the cache landed"


def _port_run(inp, name, dtype):
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    dt = getattr(torch, dtype)
    model = Model(_reduced(tcfgs, name),
                  ShardCtx(param_dtype=dt, compute_dtype=dt), device="cpu")
    convert.load_params(model, _nest(_params(inp, name)))
    cache = model.new_cache(B, CAP, torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
    batch = {k: _t(v) for k, v in _prefill_batch(inp, name).items()}
    logits, cache = model.prefill(batch, cache)
    got = [logits.float().numpy()]
    for i in range(STEPS):
        logits, cache = model.decode(cache, {
            k: _t(v) for k, v in _decode_batch(inp, name, i).items()})
        got.append(logits.float().numpy())
    return got, cache


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax_fp32(inp, jax_out, name):
    got, cache = _port_run(inp, name, "float32")
    for i, x in enumerate(got):
        want = jax_out[f"logits/{name}/fp32/{i}"]
        assert x.shape == want.shape
        err = np.abs(x - want).max() / max(1.0, np.abs(want).max())
        assert err <= FP32_RTOL, f"{name} step {i}: {err:.3g}"
    valid = S + STEPS
    np.testing.assert_allclose(cache["k"][:, :, :valid].numpy(),
                               jax_out[f"kv/{name}"][:, :, :valid],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax_bf16(inp, jax_out, name):
    got, _ = _port_run(inp, name, "bfloat16")
    for i, x in enumerate(got):
        np.testing.assert_allclose(x, jax_out[f"logits/{name}/bf16/{i}"],
                                   rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=f"{name} step {i}")


def _port_engine(inp, cache_len, eos_id):
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.serving import serve_step as ss
    from repro_torch.serving.engine import Engine, Request
    setup = ss.build_serve(_reduced(tcfgs, DENSE), ShapeConfig(
        "t", "decode", seq_len=cache_len, global_batch=2),
        param_dtype=torch.float32, device="cpu",
        compute_dtype=torch.float32)
    setup.cache_dtype = torch.float32
    convert.load_params(setup.model, _nest(_params(inp, DENSE)))
    eng = Engine(setup, eos_id=eos_id)
    return eng.generate([Request(i, list(p), max_new=n) for i, (p, n)
                         in enumerate(zip(PROMPTS, MAX_NEW))])


@pytest.mark.parametrize("case", list(ENGINE))
def test_engine_matches_jax(inp, jax_out, own_world, case):
    cache_len, use_eos = ENGINE[case]
    eos = int(jax_out["engine/eos_id"]) if use_eos else -1
    done = _port_engine(inp, cache_len, eos)
    for r in done:
        assert r.out == jax_out[f"engine/{case}/{r.rid}"].tolist(), \
            (case, r.rid)
    if case == "greedy":
        assert [len(r.out) for r in done] == list(MAX_NEW)
    elif case == "eos":
        assert done[1].out[-1] == eos and len(done[1].out) <= 3
    else:           # cur + 1 >= cache_len stops after cache_len - 3 steps
        assert [len(r.out) for r in done] == [cache_len - 3] * 2


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2])
