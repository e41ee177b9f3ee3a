"""The port's Mamba2 blocks (``repro_torch.models.mamba2``) and hybrid
model (the zamba2 groups of ``repro_torch.models.model``) against the JAX
package's (``repro.models.mamba2``, ``repro.models.model``), from the same
numpy inputs and carried-over parameters, computing in fp32 on both sides
unless a case says otherwise.

* ``ssd_chunked`` and ``ssd_reference`` at a padded length (l = 37, chunk
  8) from a nonzero ``h0``: outputs, final states, and the gradients of
  ``sum(y * r) + sum(h * q)`` with respect to every input, which must be
  finite (the ``-inf`` above the diagonal has a zero gradient).
* ``causal_conv`` in fp32 and bf16, ``_grouped_rmsnorm``, and
  ``mamba_block_apply``'s output and gradients (``jax.grad``) on group 0's
  first block of the reduced ``zamba2-2.7b`` at a sequence that pads its
  chunk.
* The leaf names, shapes, dtypes and order of the full and the reduced
  zamba2 under fp32 and bf16 parameters equal JAX's ``abstract_init``
  (``A_log``, ``D`` and ``dt_bias`` stay fp32); ``convert.load_params``
  carries a bf16 JAX tree over bit for bit.
* ``Model.loss`` and its gradients on the reduced arch with every
  ``lora.*.b`` nonzero (zero ``b`` would make the LoRA path and ``a``'s
  gradient trivially zero); the port's ``remat="full"`` (nested: each
  group, and in it the shared block and each Mamba2 block) gives the same
  bits as ``remat="none"``.
* The port's init: ``lora.*.b`` zeros, ``D`` ones, ``A_log`` the fp32
  rounding of ``log(linspace(1, 16, H))``, ``dt_bias`` inside its range.

Tolerances: fp32 with sums in other orders.  Outputs and states
``rtol=1e-5`` plus an absolute ``1e-6`` of the largest entry; losses
``rtol=1e-5``; gradients ``rtol=1e-4`` plus an absolute ``1e-5`` of the
leaf's largest entry (``tests/test_torch_model.py``'s rule), but
``BLOCK_GRAD`` (1e-4) for the lone block on unit-normal inputs: against
an fp64 evaluation of the same block, the port's fp32 gradients of the
leaves that feed ``dt``, ``B`` and ``C`` are within 6.4e-5 of the largest
entry and JAX's within 3e-6; PyTorch's CPU matmul (MKL, as numpy's)
rounds ``in_dt`` and ``in_bc`` differently from XLA's, and the decays
amplify it (fp64 matmuls bring the port to 2e-6).  In bf16 the
shift-and-sum adds in JAX's order, but XLA's bf16 sigmoid on the CPU is
not correctly rounded where PyTorch's is, so the convolution's SiLU may
differ by up to 2 bf16 units in the last place.  JAX's ``log`` on the CPU
may miss the correctly rounded ``A_log`` by one fp32 unit.
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
from repro.models import mamba2 as jm
from repro.models.layers import ShardCtx as JShardCtx
from repro.models.transformer import StepState
from repro_torch import convert
from repro_torch.configs import base as tcfgs
from repro_torch.models import mamba2 as tm
from repro_torch.models.layers import ShardCtx as TShardCtx
from repro_torch.models.model import Model as TModel

ARCH = "zamba2-2.7b"
SEQ = 40                      # the reduced arch's chunk is 32: pads
#: the block's gradients: absolute share of the leaf's largest entry
BLOCK_GRAD = 1e-4


def _close(got, want, rtol=1e-5, scale=1e-6, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()),
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ SSD
@pytest.fixture(scope="module")
def ssd():
    rng = np.random.default_rng(3)
    b, l, h, p, n = 2, 37, 3, 4, 5
    ins = dict(x=rng.standard_normal((b, l, h, p)),
               dt=0.5 * np.abs(rng.standard_normal((b, l, h))),
               A=-np.exp(rng.standard_normal(h)),
               Bm=rng.standard_normal((b, l, n)),
               Cm=rng.standard_normal((b, l, n)),
               h0=rng.standard_normal((b, h, p, n)))
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    r = rng.standard_normal((b, l, h, p)).astype(np.float32)
    q = rng.standard_normal((b, h, p, n)).astype(np.float32)
    names = list(ins)

    def jloss(fn, *args):
        y, hf = fn(*args)
        return jnp.sum(y * r) + jnp.sum(hf * q), (y, hf)

    def jax_side(fn):
        def f(x, dt, A, Bm, Cm, h0):
            return jloss(fn, x, dt, A, Bm, Cm, h0)
        (_, out), g = jax.value_and_grad(f, argnums=tuple(range(6)),
                                         has_aux=True)(
            *(jnp.asarray(ins[k]) for k in names))
        return [np.asarray(o) for o in out], [np.asarray(a) for a in g]

    def torch_side(fn):
        args = [_t(ins[k]).requires_grad_() for k in names]
        y, hf = fn(*args)
        g = torch.autograd.grad((y * _t(r)).sum() + (hf * _t(q)).sum(),
                                args)
        return [y.detach().numpy(), hf.detach().numpy()], \
            [a.numpy() for a in g]

    return {
        "jax chunked": jax_side(lambda *a: jm.ssd_chunked(*a[:5], 8,
                                                          h0=a[5])),
        "jax reference": jax_side(lambda *a: jm.ssd_reference(*a[:5],
                                                              h0=a[5])),
        "chunked": torch_side(lambda *a: tm.ssd_chunked(*a[:5], 8,
                                                        h0=a[5])),
        "reference": torch_side(lambda *a: tm.ssd_reference(*a[:5],
                                                            h0=a[5])),
        "names": names}


@pytest.mark.parametrize("port", ["chunked", "reference"])
def test_ssd_equals_jax_with_padding_and_h0(ssd, port):
    (ty, th), _ = ssd[port]
    for ref in ("jax chunked", "jax reference"):
        (jy, jh), _ = ssd[ref]
        assert ty.shape == jy.shape == (2, 37, 3, 4)
        _close(ty, jy, what=f"y vs {ref}")
        _close(th, jh, what=f"h_final vs {ref}")


@pytest.mark.parametrize("port", ["chunked", "reference"])
def test_ssd_gradients_are_finite_and_equal_jax(ssd, port):
    _, tg = ssd[port]
    _, jg = ssd["jax chunked"]
    for name, got, want in zip(ssd["names"], tg, jg):
        assert np.isfinite(got).all(), name
        _close(got, want, rtol=1e-4, scale=1e-5, what=name)


def test_segsum_masks_above_the_diagonal_with_minus_inf():
    s = torch.tensor([[-0.5, -1.25, -3.0]])
    got = tm._segsum(s)
    want = np.asarray(jm._segsum(jnp.asarray(s.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.isneginf(got[0].triu(1)[0, 1:]).all()


# ---------------------------------------------------------- conv, norm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_equals_jax(dtype):
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.standard_normal((2, 37, 48)), dtype)
    k = jnp.asarray(0.5 * rng.standard_normal((4, 48)), dtype)
    want, _ = jm.causal_conv(u, k)
    got = tm.causal_conv(convert.to_tensor(np.asarray(u)),
                         convert.to_tensor(np.asarray(k)))
    assert str(got.dtype) == f"torch.{dtype}"
    want = np.asarray(want)
    if dtype == "float32":
        _close(got.numpy(), want)
        return
    ulps = np.abs(got.view(torch.int16).numpy().astype(np.int32)
                  - want.view(np.int16).astype(np.int32))
    assert ulps.max() <= 2
    assert (np.sign(got.float().numpy()) == np.sign(
        want.astype(np.float32))).all()


def test_grouped_rmsnorm_equals_jax():
    rng = np.random.default_rng(5)
    y, z = (rng.standard_normal((2, 9, 64)).astype(np.float32)
            for _ in range(2))
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jm._grouped_rmsnorm(*(jnp.asarray(a) for a in (scale, y, z)),
                               16, 1e-5)
    got = tm._grouped_rmsnorm(_t(scale), _t(y), _t(z), 16, 1e-5)
    _close(got.numpy(), want)


# ---------------------------------------------------------------- block
@pytest.fixture(scope="module")
def block():
    jcfg = jcfgs.reduced(jcfgs.get(ARCH))
    tcfg = tcfgs.reduced(tcfgs.get(ARCH))
    jctx = JShardCtx(compute_dtype=jnp.float32)
    params, _ = JModel(jcfg).init(jax.random.key(1), jctx)
    p0 = jax.tree.map(lambda a: a[0, 0], params["groups"]["mamba"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, SEQ, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    st = StepState(mode="train")

    def jloss(p, xx):
        y, _ = jm.mamba_block_apply(p, xx, jctx, jcfg, st)
        return jnp.sum(y * r), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(p0,
                                                           jnp.asarray(x))
    host = convert.flatten(jax.device_get(p0))
    tp = {k: convert.to_tensor(v).requires_grad_() for k, v in host.items()}
    tx = _t(x).requires_grad_()
    ty = tm.mamba_block_apply(tp, tx, tcfg,
                              TShardCtx(compute_dtype=torch.float32))
    tg = torch.autograd.grad((ty * _t(r)).sum(), (*tp.values(), tx))
    return dict(jy=np.asarray(jy), ty=ty.detach().numpy(),
                jgrads={**convert.flatten(jax.device_get(jgp)),
                        "x": np.asarray(jgx)},
                tgrads={**{k: g.numpy() for k, g in zip(tp, tg[:-1])},
                        "x": tg[-1].numpy()})


def test_mamba_block_output_equals_jax(block):
    assert block["ty"].shape == block["jy"].shape
    _close(block["ty"], block["jy"], what="y")


def test_mamba_block_gradients_equal_jax(block):
    assert sorted(block["tgrads"]) == sorted(block["jgrads"])
    for name, want in block["jgrads"].items():
        assert np.abs(want).max() > 0, name
        _close(block["tgrads"][name], want, rtol=1e-4, scale=BLOCK_GRAD,
               what=name)


# --------------------------------------------------------------- leaves
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_names_shapes_dtypes_and_order_equal_jax(size, dtype):
    jcfg, tcfg = jcfgs.get(ARCH), tcfgs.get(ARCH)
    if size == "reduced":
        jcfg, tcfg = jcfgs.reduced(jcfg), tcfgs.reduced(tcfg)
    shapes, _ = JModel(jcfg).abstract_init(
        JShardCtx(param_dtype=jnp.dtype(dtype)))
    want = [(".".join(str(k.key) for k in path), tuple(leaf.shape),
             str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]]
    model = TModel(tcfg, TShardCtx(param_dtype=getattr(torch, dtype)),
                   device="meta")
    got = [(n, tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()]
    assert got == want
    assert [p for _, p in model.named_parameters()] == \
        list(model.parameters())
    fp32 = {n for n, _, d in got if d == "float32"}
    assert fp32 == ({n for n, _, _ in got} if dtype == "float32" else
                    {"groups.mamba.A_log", "groups.mamba.D",
                     "groups.mamba.dt_bias"})
    if size == "full":
        shape = dict((n, s) for n, s, _ in got)
        assert shape["groups.mamba.in_x.w"] == (9, 6, 2560, 5120)
        assert shape["groups.lora.gate.b"] == (9, 64, 10240)
        assert sum(int(np.prod(s)) for s in shape.values()) == \
            2_440_081_568


def test_convert_carries_each_leaf_in_its_own_dtype():
    jcfg = jcfgs.reduced(jcfgs.get(ARCH))
    params, _ = JModel(jcfg).init(jax.random.key(2),
                                  JShardCtx(param_dtype=jnp.bfloat16))
    flat = convert.flatten(jax.device_get(params))
    model = TModel(tcfgs.reduced(tcfgs.get(ARCH)),
                   TShardCtx(param_dtype=torch.bfloat16), device="cpu")
    convert.load_params(model, jax.device_get(params))
    for name, p in model.named_parameters():
        want = convert.to_tensor(flat[name])
        assert p.dtype == want.dtype, name
        bits = torch.int16 if p.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(p.detach().view(bits), want.view(bits)), name


# ---------------------------------------------------------------- model
@pytest.fixture(scope="module")
def model_pair():
    jcfg = jcfgs.reduced(jcfgs.get(ARCH))
    jctx = JShardCtx(compute_dtype=jnp.float32)
    jmodel = JModel(jcfg)
    params, _ = jmodel.init(jax.random.key(0), jctx)
    rng = np.random.default_rng(7)
    lora = params["groups"]["lora"]
    for w in lora:                         # nonzero b: a live LoRA path
        lora[w]["b"] = jnp.asarray(0.05 * rng.standard_normal(
            lora[w]["b"].shape), jnp.float32)
    batch = batch_at(DataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                                global_batch=2), 0)

    def loss_fn(p):
        loss_sum, ntok, _ = jmodel.loss(p, batch, jctx)
        return loss_sum, ntok

    (jl, jn), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    out = dict(j=(float(jl), int(jn)),
               jgrads=convert.flatten(jax.device_get(jg)))
    tcfg = tcfgs.reduced(tcfgs.get(ARCH))
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tcfg, plan=dataclasses.replace(
            tcfg.plan, remat=remat))
        tmodel = TModel(cfg, TShardCtx(compute_dtype=torch.float32),
                        device="cpu")
        convert.load_params(tmodel, jax.device_get(params))
        tl, tn, ta = tmodel.loss({k: torch.from_numpy(v).long()
                                  for k, v in batch.items()})
        tg = torch.autograd.grad(tl, list(tmodel.parameters()))
        out[remat] = dict(t=(tl.item(), int(tn), ta.item()),
                          tgrads=dict(zip([n for n, _ in
                                           tmodel.named_parameters()], tg)))
    return out


def test_model_loss_equals_jax(model_pair):
    (jl, jn), (tl, tn, ta) = model_pair["j"], model_pair["none"]["t"]
    assert tn == jn == 2 * SEQ
    assert ta == 0.0
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_model_gradients_equal_jax(model_pair):
    tgrads = model_pair["none"]["tgrads"]
    assert list(tgrads) == list(model_pair["jgrads"])
    for name, g in tgrads.items():
        want = model_pair["jgrads"][name]
        assert np.abs(want).max() > 0, name       # every leaf is live
        _close(g.numpy(), want, rtol=1e-4, scale=1e-5, what=name)


def test_nested_remat_gives_the_same_bits(model_pair):
    a, b = model_pair["none"], model_pair["full"]
    assert a["t"] == b["t"]
    for name, g in a["tgrads"].items():
        assert torch.equal(g, b["tgrads"][name]), name


def test_init_statistics():
    cfg = tcfgs.reduced(tcfgs.get(ARCH))
    model = TModel(cfg, TShardCtx(param_dtype=torch.bfloat16), device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    p = dict(model.named_parameters())
    for w in ("gate", "up", "wq"):
        assert not p[f"groups.lora.{w}.b"].any()
        a = p[f"groups.lora.{w}.a"].float()
        assert a.std().item() == pytest.approx(cfg.d_model ** -0.5,
                                               rel=0.1)
    h = p["groups.mamba.D"].shape[-1]
    assert torch.equal(p["groups.mamba.D"], torch.ones(2, 2, h))
    want = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    a_log = p["groups.mamba.A_log"].detach().numpy()
    np.testing.assert_array_equal(a_log, np.broadcast_to(want, a_log.shape))
    jax_a_log = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, h)))
    np.testing.assert_array_less(np.abs(want - jax_a_log),
                                 np.spacing(np.abs(want)) * 1.01 + 1e-30)
    dt_bias = p["groups.mamba.dt_bias"].detach().double()
    lo, hi = (np.log(np.expm1(v)) for v in (tm.DT_MIN, tm.DT_MAX))
    assert lo - 1e-5 <= dt_bias.min().item() < dt_bias.max().item() \
        <= hi + 1e-5
    dt = torch.nn.functional.softplus(dt_bias)
    assert dt.log().mean().item() == pytest.approx(
        (np.log(tm.DT_MIN) + np.log(tm.DT_MAX)) / 2, abs=0.6)
    assert len(set(dt_bias.flatten().tolist())) == dt_bias.numel()
