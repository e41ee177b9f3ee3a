"""The port's enc-dec pieces (``repro_torch.models.{layers,attention,
transformer,encdec}``) and audio model (the encoder and decoder stacks of
``repro_torch.models.model``) against the JAX package's, from the same
numpy inputs and carried-over parameters, computing in fp32 on both
sides unless a case says otherwise.

* ``sinusoidal_positions`` at positions up to 1100, d 128 and 30.
* ``attention`` against ``chunked_attention``, causal and not, with
  ``Sq != Sk`` and grouped heads (4 query heads on 2 key/value heads),
  outputs and the gradients of q, k and v; once at ``Sk = 1100``, where
  JAX walks the keys in two chunks of 1024 (the second padded) and the
  port takes one softmax; ``causal_attention`` as the causal case.
* The GELU MLP against JAX's ``mlp_apply(kind="gelu")``, and the same
  inputs through the exact GELU, which must miss JAX's output.
* ``enc_block_apply`` and ``dec_block_apply`` of the reduced
  ``seamless-m4t-medium`` (d_model 128, 4 heads of 32, d_ff 256; decoder
  20 tokens over a memory of 28), outputs and the gradients of every
  parameter, of the input and, for the decoder, of the memory; in fp32
  and with bf16 parameters and compute.
* The reduced model (2 encoder and 2 decoder blocks, vocab 512):
  ``Model.loss`` and every leaf's gradient in fp32 and in bf16 compute;
  ``remat="full"`` gives the bits of ``"none"``; a batch without
  ``enc_embeds`` raises a ``KeyError`` naming it.
* The leaf names, shapes, dtypes and order of the reduced and the full
  arch against JAX's ``init`` through ``convert.flatten`` and its
  ``abstract_init``; ``param_count`` 877,094,912 on ``meta``, equal to
  JAX's; ``resolve_plan`` on the full-size arch equal to JAX's.

Tolerances: fp32 with sums in other orders.  Positions: absolute 1e-6
(the same fp32 angles on both sides; measured 6e-8).  Outputs
``rtol=1e-5`` plus an absolute ``1e-6`` of the largest entry; the
1100-key attention ``rtol=1e-5`` plus ``1e-5`` (one softmax against two
chunks merged; measured 7.6e-7); losses ``rtol=1e-5``; gradients
``rtol=1e-4`` plus ``1e-5`` of the leaf's largest entry
(``tests/test_torch_model.py``'s rule).  bf16: outputs within
``BF16_OUT`` (2e-2) of the largest entry, gradients and the loss within
a relative difference of ``BF16_GRAD`` (5e-2), the rule of
``tests/test_torch_xlstm.py`` (measured: block outputs 0.3-0.6%,
gradients 0.6-0.7%): each package rounds the bf16 matmuls' and norms'
intermediates at its own points.  JAX runs the bf16 cases op by op and
the others under ``jax.jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.data.synthetic import DataConfig, batch_at
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.layers import ShardCtx as JShardCtx
from repro.models.transformer import Aux, StepState
from repro_torch import convert
from repro_torch.configs import base as tcfgs
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import ShardCtx as TShardCtx
from repro_torch.models.model import Model as TModel

ARCH = "seamless-m4t-medium"
FULL_COUNT = 877_094_912
S_DEC, S_ENC = 20, 28
BF16_OUT = 2e-2
BF16_GRAD = 5e-2


def _close(got, want, rtol=1e-5, scale=1e-6, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()),
                               err_msg=what)


def _rel(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _t(a):
    return convert.to_tensor(np.asarray(a))


def _cfgs():
    return jcfgs.reduced(jcfgs.get(ARCH)), tcfgs.reduced(tcfgs.get(ARCH))


def _jax_init(jcfg, jctx, seed):
    return jax.jit(lambda k: JModel(jcfg).init(k, jctx)[0])(
        jax.random.key(seed))


# ------------------------------------------------------------ positions
@pytest.mark.parametrize("d", [128, 30])
def test_sinusoidal_positions_equal_jax(d):
    pos = np.random.default_rng(0).integers(0, 1100, (3, 17))
    want = np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos), d))
    got = tlayers.sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (3, 17, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # exactly [sin | cos] of position 0
    zero = tlayers.sinusoidal_positions(torch.zeros(1, dtype=torch.int64), d)
    assert torch.equal(zero[0], torch.cat([torch.zeros(d // 2),
                                           torch.ones(d // 2)]))


# ------------------------------------------------------------ attention
#: name -> (Sq, Sk, causal)
ATTN_CASES = {"causal": (12, 20, True), "bidirectional": (12, 20, False),
              "cross-longer-q": (20, 12, False),
              "1100-keys": (8, 1100, False),
              "1100-keys-causal": (8, 1100, True)}


def _attn_run(sq, sk, causal):
    rng = np.random.default_rng(1)
    b, h, kvh, hd = 2, 4, 2, 16
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    r = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    # the queries are the last Sq positions of the keys' (a causal suffix)
    qpos = np.broadcast_to(np.arange(sk - sq, sk) if sq <= sk
                           else np.arange(sq), (b, sq))
    kpos = np.broadcast_to(np.arange(sk), (b, sk))

    def jf(q, k, v):
        out = jattn.chunked_attention(q, k, v, causal=causal,
                                      q_positions=jnp.asarray(qpos),
                                      k_positions=jnp.asarray(kpos))
        return jnp.sum(out * r), out
    (_, jout), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    if causal:
        tout = tattn.attention(tq, tk, tv, _t(qpos), _t(kpos), causal=True)
    else:
        tout = tattn.attention(tq, tk, tv, causal=False)
    tg = torch.autograd.grad((tout * _t(r)).sum(), (tq, tk, tv))
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jg], [g.numpy() for g in tg])


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_equals_jax(case):
    sq, sk, causal = ATTN_CASES[case]
    jout, tout, jg, tg = _attn_run(sq, sk, causal)
    scale = 1e-5 if sk > 1024 else 1e-6
    _close(tout, jout, scale=scale, what="out")
    for name, got, want in zip("qkv", tg, jg):
        assert np.abs(want).max() > 0, name
        _close(got, want, rtol=1e-4, scale=1e-5, what=name)


def test_causal_attention_is_the_causal_case():
    rng = np.random.default_rng(2)
    q, k, v = (_t(rng.standard_normal((2, 9, 4, 8)).astype(np.float32))
               for _ in range(3))
    pos = torch.arange(9).expand(2, 9)
    want = tattn.attention(q, k, v, pos, pos, causal=True)
    assert torch.equal(tattn.causal_attention(q, k, v, pos), want)
    # the first query sees only the first key
    assert torch.allclose(want[:, 0], v[:, 0], atol=1e-6)


# ------------------------------------------------------------------- MLP
def _gelu_mlp_run():
    rng = np.random.default_rng(3)
    d, f = 64, 96
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    # fc1 outputs of order 1-3, where the two GELUs part most
    fc1 = (2.0 * rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    fc2 = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    jctx = JShardCtx(compute_dtype=jnp.float32)
    want = np.asarray(jtf.mlp_apply({"fc1": {"w": fc1}, "fc2": {"w": fc2}},
                                    jnp.asarray(x), jctx, kind="gelu"))
    p = {"mlp.fc1.w": _t(fc1), "mlp.fc2.w": _t(fc2)}
    got = ttf.gelu_mlp_apply(p, _t(x), TShardCtx(compute_dtype=torch.float32))
    return got.numpy(), want


def test_gelu_mlp_equals_jax():
    got, want = _gelu_mlp_run()
    _close(got, want, what="gelu mlp")


def test_gelu_mlp_with_the_exact_gelu_misses_jax(monkeypatch):
    """``jax.nn.gelu`` is the tanh form: the exact GELU (PyTorch's
    default) leaves the tolerance ``test_gelu_mlp_equals_jax`` holds."""
    exact = torch.nn.functional.gelu
    monkeypatch.setattr(torch.nn.functional, "gelu",
                        lambda x, approximate="none": exact(x))
    got, want = _gelu_mlp_run()
    err = np.abs(got - want).max()
    assert err > 10 * (1e-5 * np.abs(want).max()), err


# ---------------------------------------------------------------- blocks
def _block_run(kind, dtype):
    jcfg, tcfg = _cfgs()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jctx = JShardCtx(compute_dtype=jdt, param_dtype=jdt)
    tctx = TShardCtx(compute_dtype=tdt, param_dtype=tdt)
    params = _jax_init(jcfg, jctx, 1)
    p0 = jax.tree.map(lambda a: a[0], params[f"{kind}_blocks"])
    rng = np.random.default_rng(4)
    s = S_DEC if kind == "dec" else S_ENC
    x = jnp.asarray(rng.standard_normal((2, s, jcfg.d_model)), jdt)
    mem = jnp.asarray(rng.standard_normal((2, S_ENC, jcfg.d_model)), jdt)
    r = jnp.asarray(rng.standard_normal(x.shape), jdt)
    aux = Aux(positions=jnp.broadcast_to(jnp.arange(s), (2, s)))

    def jloss(p, xx, mm):
        if kind == "enc":
            y = jed.enc_block_apply(p, xx, aux, jctx, jcfg)
        else:
            y, _ = jed.dec_block_apply(p, xx, aux, jctx, jcfg,
                                       StepState(mode="train"), None,
                                       memory=mm)
        return jnp.sum((y * r).astype(jnp.float32)), y

    # bf16 runs op by op: under jit XLA keeps bf16 intermediates in fp32
    # where the program (and the port) rounds them
    grad = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)
    (_, jy), (jgp, jgx, jgm) = (grad if dtype == "bfloat16"
                                else jax.jit(grad))(p0, x, mem)
    host = convert.flatten(jax.device_get(p0))
    tp = {k: convert.to_tensor(v).requires_grad_() for k, v in host.items()}
    tx, tm = (_t(a).requires_grad_() for a in (x, mem))
    positions = torch.arange(s).expand(2, s)
    if kind == "enc":
        ty = ted.enc_block_apply(tp, tx, positions, tcfg, tctx)
        wrt = (*tp.values(), tx)
    else:
        ty = ted.dec_block_apply(tp, tx, tm, positions, tcfg, tctx)
        wrt = (*tp.values(), tx, tm)
    assert ty.dtype == tdt
    tg = torch.autograd.grad((ty * _t(r)).float().sum(), wrt)
    jgrads = {**{k: np.asarray(v, np.float32) for k, v in
                 convert.flatten(jax.device_get(jgp)).items()},
              "x": np.asarray(jgx, np.float32)}
    tgrads = {**{k: g.float().numpy() for k, g in zip(tp, tg)},
              "x": tg[len(tp)].float().numpy()}
    if kind == "dec":
        jgrads["memory"] = np.asarray(jgm, np.float32)
        tgrads["memory"] = tg[-1].float().numpy()
    return dict(jy=np.asarray(jy, np.float32),
                ty=ty.detach().float().numpy(), jgrads=jgrads, tgrads=tgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_block_output_and_gradients_equal_jax(kind, dtype):
    r = _block_run(kind, dtype)
    assert r["ty"].shape == r["jy"].shape
    assert sorted(r["tgrads"]) == sorted(r["jgrads"])
    if kind == "dec":
        assert {"memory", "cross.wk.w", "cross.wv.w", "ln3.scale"} <= \
            set(r["tgrads"])
    if dtype == "float32":
        _close(r["ty"], r["jy"], what="y")
    else:
        _close(r["ty"], r["jy"], rtol=0, scale=BF16_OUT, what="y")
    for name, want in r["jgrads"].items():
        assert np.abs(want).max() > 0, name
        got = r["tgrads"][name]
        assert np.isfinite(got).all(), name
        if dtype == "float32":
            _close(got, want, rtol=1e-4, scale=1e-5, what=name)
        else:
            assert _rel(got, want) <= BF16_GRAD, (name, _rel(got, want))


# --------------------------------------------------------------- leaves
def _leaves(tree):
    return [(".".join(str(k.key) for k in path), tuple(leaf.shape),
             str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_names_shapes_dtypes_and_order_equal_jax(dtype):
    """The reduced arch against JAX's ``init`` through
    ``convert.flatten`` (which ``convert.load_params`` follows), the full
    arch against ``abstract_init``."""
    jcfg, tcfg = _cfgs()
    tdt = getattr(torch, dtype)
    params = jax.device_get(_jax_init(jcfg, JShardCtx(
        param_dtype=jnp.dtype(dtype)), 0))
    flat = convert.flatten(params)
    model = TModel(tcfg, TShardCtx(param_dtype=tdt), device="meta")
    got = [(n, tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()]
    assert got == [(n, tuple(a.shape), str(a.dtype))
                   for n, a in flat.items()]
    assert [n for n, _, _ in got][12:15] == [
        "dec_blocks.self.wv.w", "embed.table", "enc_blocks.attn.wk.w"]
    assert [p for _, p in model.named_parameters()] == \
        list(model.parameters())
    assert model.stacks == (("dec_blocks.", 2), ("enc_blocks.", 2))
    shapes, _ = JModel(jcfgs.get(ARCH)).abstract_init(
        JShardCtx(param_dtype=jnp.dtype(dtype)))
    full = TModel(tcfgs.get(ARCH), TShardCtx(param_dtype=tdt), device="meta")
    got = [(n, tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in full.named_parameters()]
    assert got == _leaves(shapes)
    assert full.stacks == (("dec_blocks.", 12), ("enc_blocks.", 12))
    shape = dict((n, s) for n, s, _ in got)
    assert shape["dec_blocks.cross.wq.w"] == (12, 1024, 1024)
    assert shape["enc_blocks.mlp.fc2.w"] == (12, 4096, 1024)
    assert shape["unembed.table"] == (256206, 1024)
    assert sum(int(np.prod(s)) for s in shape.values()) == FULL_COUNT


def test_param_count_and_resolve_plan_equal_jax():
    from repro.adaptive import controller as jctl
    from repro_torch.adaptive import controller as tctl
    ja, ta = jcfgs.get(ARCH), tcfgs.get(ARCH)
    assert ta.param_count() == ja.param_count() == FULL_COUNT
    assert ta.active_param_count() == ja.active_param_count() == FULL_COUNT
    jp, jd = jctl.resolve_plan(ja.plan, ja, 2, batch=4, seq=512)
    tp, td = tctl.resolve_plan(ta.plan, ta, 2, batch=4, seq=512)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert tp.dp_mode == "ddp" and tp.zero1


# ---------------------------------------------------------------- model
def _batch(jcfg):
    batch = batch_at(DataConfig(vocab=jcfg.vocab, seq_len=S_DEC,
                                global_batch=2), 0)
    batch["enc_embeds"] = np.random.default_rng(5).standard_normal(
        (2, S_ENC, jcfg.d_model)).astype(np.float32)
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model_pair(request):
    """JAX's and the port's loss and gradients of the reduced arch from
    the same fp32 parameters and batch, computing in ``request.param``;
    the port under ``remat="none"`` and ``"full"``."""
    jcfg, tcfg = _cfgs()
    cdt = request.param
    jctx = JShardCtx(compute_dtype=jnp.dtype(cdt))
    jmodel = JModel(jcfg)
    params = _jax_init(jcfg, jctx, 0)
    batch = _batch(jcfg)

    def loss_fn(p):
        loss_sum, ntok, _ = jmodel.loss(p, batch, jctx)
        return loss_sum, ntok

    grad = jax.value_and_grad(loss_fn, has_aux=True)
    (jl, jn), jg = (grad if cdt == "bfloat16" else jax.jit(grad))(params)
    out = dict(dtype=cdt, j=(float(jl), int(jn)),
               jgrads=convert.flatten(jax.device_get(jg)))
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tcfg, plan=dataclasses.replace(
            tcfg.plan, remat=remat))
        tmodel = TModel(cfg, TShardCtx(compute_dtype=getattr(torch, cdt)),
                        device="cpu")
        convert.load_params(tmodel, jax.device_get(params))
        tl, tn, ta = tmodel.loss(_to_torch(batch))
        tg = torch.autograd.grad(tl, list(tmodel.parameters()))
        out[remat] = dict(t=(tl.item(), int(tn), ta.item()),
                          tgrads=dict(zip([n for n, _ in
                                           tmodel.named_parameters()], tg)))
    return out


def test_model_loss_equals_jax(model_pair):
    (jl, jn), (tl, tn, ta) = model_pair["j"], model_pair["none"]["t"]
    assert tn == jn == 2 * S_DEC
    assert ta == 0.0
    rtol = 1e-5 if model_pair["dtype"] == "float32" else BF16_GRAD
    np.testing.assert_allclose(tl, jl, rtol=rtol)


def test_model_gradients_equal_jax(model_pair):
    tgrads = model_pair["none"]["tgrads"]
    assert list(tgrads) == list(model_pair["jgrads"])
    for name, g in tgrads.items():
        want = model_pair["jgrads"][name]
        assert np.abs(want).max() > 0, name       # every leaf is live
        if model_pair["dtype"] == "float32":
            _close(g.numpy(), want, rtol=1e-4, scale=1e-5, what=name)
        else:
            assert _rel(g.numpy(), want) <= BF16_GRAD, (
                name, _rel(g.numpy(), want))


def test_remat_gives_the_same_bits(model_pair):
    a, b = model_pair["none"], model_pair["full"]
    assert a["t"] == b["t"]
    for name, g in a["tgrads"].items():
        assert torch.equal(g, b["tgrads"][name]), name


def test_loss_without_enc_embeds_names_it():
    _, tcfg = _cfgs()
    model = TModel(tcfg, TShardCtx(compute_dtype=torch.float32),
                   device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    batch = _to_torch(_batch(jcfgs.reduced(jcfgs.get(ARCH))))
    del batch["enc_embeds"]
    with pytest.raises(KeyError, match="enc_embeds"):
        model.loss(batch)
