"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and ssm model (the
xLSTM groups of ``repro_torch.models.model``) against the JAX package's
(``repro.models.xlstm``, ``repro.models.model``), from the same numpy
inputs and carried-over parameters, computing in fp32 on both sides
unless a case says otherwise.

* ``mlstm_reference`` and ``mlstm_chunked`` at l = 40, chunk 16 (pads, 3
  chunks) with a carry in, at l = 40 from the zero carry, and at l = 12 <
  chunk: outputs, final carries, and the gradients of ``sum(y * r) +
  sum(C * u) + sum(n * w)`` with respect to every input.  JAX's chunked
  form against JAX's reference checks the oracle itself.
* ``slstm_scan`` from the zero state and from a carry in, and a tie case:
  the i slice of ``r_gates`` zeroed and the i-gate pre-activations equal
  across each head, so that the head maximum ties (``torch.amax`` splits
  the gradient as ``jnp.max`` does; the same scan with ``max(dim)`` in
  its place is shown to miss JAX's gradient), and once more with
  ``SLSTM_BF16_RECURRENCE`` set on both sides.
* One mLSTM block and one sLSTM block of the reduced ``xlstm-350m`` at
  d_model 64 (sequence 40: the chunk of 32 pads), outputs and the
  gradients of every parameter and the input, in fp32 and with bf16
  parameters and compute.
* ``mlstm_chunked`` and its backward with ``opt_einsum`` off, as the
  card's machine runs it: no op produces a tensor larger than the padded
  inputs and outputs, the carry or one chunk's weights (a three-operand
  einsum contracted left to right would build ``(b, c, h, dv, dk)``).
* The leaf names, shapes, dtypes and order of the full and the reduced
  arch under fp32 and bf16 parameters equal JAX's ``abstract_init``
  (``b_if``, ``w_if``, ``b_gates``, ``r_gates`` and ``w_gates`` stay
  fp32; 314,143,912 parameters at full size); ``Model.loss`` and its
  gradients on the reduced arch; nested remat gives the same bits as
  none; the port's init draws ``b_if`` and ``b_gates`` as JAX's.

Tolerances: fp32 with sums in other orders.  Outputs and carries
``rtol=1e-5`` plus an absolute ``1e-6`` of the largest entry; losses
``rtol=1e-5``; gradients ``rtol=1e-4`` plus an absolute ``1e-5`` of the
leaf's largest entry (``tests/test_torch_model.py``'s rule).  The bf16
recurrence: ``rtol=1e-2`` plus ``1e-2`` of the largest entry (bf16 has 8
bits; each package rounds its own bf16 product).  The bf16 blocks:
outputs within ``BF16_OUT`` (2e-2) of the largest entry (measured
0.7-1.2%), gradients within a relative L2 difference of ``BF16_GRAD``
(5e-2; measured 0.6-2.7%): each package's bf16 gradients sit 2-5% from
the fp32 evaluation of the same block (``b_if``: JAX 5.4%, the port
3.9%), and they round the bf16 matmuls' and norms' intermediates at
different points.  JAX runs the bf16 blocks op by op, the other cases
under ``jax.jit``: under jit XLA keeps bf16 intermediates in fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as jcfgs
from repro.data.synthetic import DataConfig, batch_at
from repro.models import Model as JModel
from repro.models import xlstm as jx
from repro.models.layers import ShardCtx as JShardCtx
from repro.models.transformer import StepState
from repro_torch import convert
from repro_torch.configs import base as tcfgs
from repro_torch.models import xlstm as tx
from repro_torch.models.layers import ShardCtx as TShardCtx
from repro_torch.models.model import Model as TModel

ARCH = "xlstm-350m"
SEQ = 40                      # the reduced arch's chunk is 32: pads
BF16_OUT = 2e-2
BF16_GRAD = 5e-2


def _close(got, want, rtol=1e-5, scale=1e-6, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()),
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_init(jcfg, jctx, seed):
    """JAX's parameters of ``jcfg`` from ``key(seed)``, drawn under one
    jit."""
    return jax.jit(lambda k: JModel(jcfg).init(k, jctx)[0])(
        jax.random.key(seed))


def _rel(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------- mLSTM
def _mlstm_inputs(l, carry, seed=3):
    rng = np.random.default_rng(seed)
    b, h, dk, dv = 2, 2, 8, 6
    ins = dict(q=rng.standard_normal((b, l, h, dk)),
               k=rng.standard_normal((b, l, h, dk)),
               v=rng.standard_normal((b, l, h, dv)),
               i=rng.standard_normal((b, l, h)),
               f=rng.standard_normal((b, l, h)) + 2.0)
    if carry:
        ins.update(C=rng.standard_normal((b, h, dv, dk)),
                   n=rng.standard_normal((b, h, dk)),
                   m=0.5 * rng.standard_normal((b, h)))
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    w = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("y", (b, l, h, dv)), ("C", (b, h, dv, dk)), ("n", (b, h, dk)))}
    return ins, w


def _mlstm_run(fn_name, l, carry, chunk=16):
    ins, w = _mlstm_inputs(l, carry)
    names = list(ins)

    def jfn(*a):
        kw = dict(zip(names, a))
        cr = (kw["C"], kw["n"], kw["m"]) if carry else None
        args = (kw["q"], kw["k"], kw["v"], kw["i"], kw["f"])
        if fn_name == "chunked":
            y, (C, n, m) = jx.mlstm_chunked(*args, chunk, carry=cr)
        else:
            y, (C, n, m) = jx.mlstm_reference(*args, carry=cr)
        loss = jnp.sum(y * w["y"]) + jnp.sum(C * w["C"]) \
            + jnp.sum(n * w["n"])
        return loss, (y, C, n, m)

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(len(names))), has_aux=True))(
            *(jnp.asarray(ins[k]) for k in names))
    args = {k: _t(v).requires_grad_() for k, v in ins.items()}
    cr = (args["C"], args["n"], args["m"]) if carry else None
    targs = (args["q"], args["k"], args["v"], args["i"], args["f"])
    if fn_name == "chunked":
        y, (C, n, m) = tx.mlstm_chunked(*targs, chunk, carry=cr)
    else:
        y, (C, n, m) = tx.mlstm_reference(*targs, carry=cr)
    loss = (y * _t(w["y"])).sum() + (C * _t(w["C"])).sum() \
        + (n * _t(w["n"])).sum()
    tg = torch.autograd.grad(loss, list(args.values()))
    return dict(j=[np.asarray(a) for a in jout],
                t=[a.detach().numpy() for a in (y, C, n, m)],
                jg=dict(zip(names, (np.asarray(g) for g in jg))),
                tg=dict(zip(names, (g.numpy() for g in tg))))


MLSTM_CASES = {"l40-carry": (40, True), "l40": (40, False),
               "l12-short": (12, False)}


@pytest.fixture(scope="module")
def mlstm():
    return {(fn, case): _mlstm_run(fn, *MLSTM_CASES[case])
            for fn in ("chunked", "reference") for case in MLSTM_CASES}


@pytest.mark.parametrize("case", list(MLSTM_CASES))
@pytest.mark.parametrize("fn", ["chunked", "reference"])
def test_mlstm_equals_jax(mlstm, fn, case):
    r = mlstm[(fn, case)]
    for what, got, want in zip("yCnm", r["t"], r["j"]):
        assert got.shape == want.shape, what
        _close(got, want, what=what)
    for name, want in r["jg"].items():
        assert np.isfinite(r["tg"][name]).all(), name
        _close(r["tg"][name], want, rtol=1e-4, scale=1e-5, what=name)


@pytest.mark.parametrize("case", list(MLSTM_CASES))
def test_mlstm_chunked_equals_the_reference(mlstm, case):
    """The chunked form against the sequential oracle, in each package."""
    for side in ("j", "t"):
        got, want = mlstm[("chunked", case)], mlstm[("reference", case)]
        for what, a, b in zip("yCn", got[side][:3], want[side][:3]):
            # the carries differ by their stabilisers: compare C exp(m)
            if what != "y":
                scale = np.exp(got[side][3] - want[side][3])
                a = a * scale.reshape(scale.shape + (1,) * (a.ndim - 2))
            _close(a, b, rtol=1e-4, scale=1e-5, what=f"{side} {what}")


class _Biggest(TorchDispatchMode):
    """Records the largest tensor any op produces."""

    def __init__(self):
        super().__init__()
        self.numel, self.op = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel() > self.numel:
                self.numel, self.op = t.numel(), func
        return out


def test_mlstm_chunked_builds_no_five_dim_product_without_opt_einsum():
    b, h, dk, dv, chunk, l = 2, 2, 16, 32, 16, 40
    padded = -(-l // chunk) * chunk
    limit = max(b * padded * h * max(dk, dv), b * h * dv * dk,
                b * chunk * chunk * h)
    assert b * chunk * h * dv * dk >= 5 * limit
    gen = torch.Generator().manual_seed(0)
    q, k = (torch.randn(b, l, h, dk, generator=gen).requires_grad_()
            for _ in range(2))
    v = torch.randn(b, l, h, dv, generator=gen).requires_grad_()
    i, f = (torch.randn(b, l, h, generator=gen).requires_grad_()
            for _ in range(2))
    was = torch.backends.opt_einsum.enabled
    torch.backends.opt_einsum.enabled = False
    try:
        with _Biggest() as seen:
            y, (C, n, _) = tx.mlstm_chunked(q, k, v, i, f, chunk)
            grads = torch.autograd.grad(y.sum() + C.sum() + n.sum(),
                                        (q, k, v, i, f))
    finally:
        torch.backends.opt_einsum.enabled = was
    assert all(torch.isfinite(g).all() for g in grads)
    assert seen.numel <= limit, (seen.op, seen.numel, limit)


# ---------------------------------------------------------------- sLSTM
def _slstm_inputs(tie, carry, seed=4):
    rng = np.random.default_rng(seed)
    b, l, hn, hd = 2, 24, 2, 4
    gx = rng.standard_normal((b, l, 4, hn, hd))
    r = rng.standard_normal((4, hn, hd, hd)) / np.sqrt(hd)
    if tie:
        r[1] = 0.0
        gx[:, :, 1] = gx[:, :, 1, :, :1]
    ins = dict(gx=gx, r=r)
    if carry:
        ins.update(c=rng.standard_normal((b, hn, hd)),
                   n=1 + np.abs(rng.standard_normal((b, hn, hd))),
                   h=0.5 * rng.standard_normal((b, hn, hd)),
                   m=rng.standard_normal((b, hn)))
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    w = rng.standard_normal((b, l, hn, hd)).astype(np.float32)
    wc = rng.standard_normal((b, hn, hd)).astype(np.float32)
    return ins, w, wc


def _slstm_run(tie, carry):
    ins, w, wc = _slstm_inputs(tie, carry)
    names = list(ins)
    hn = ins["r"].shape[1]

    def jfn(*a):
        kw = dict(zip(names, a))
        h0 = (kw["c"], kw["n"], kw["h"], kw["m"]) if carry else None
        y, (c, n, h, m) = jx.slstm_scan(kw["gx"], kw["r"], hn, h0)
        return jnp.sum(y * w) + jnp.sum(c * wc) + jnp.sum(m), (y, c, n, h, m)

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(len(names))), has_aux=True))(
            *(jnp.asarray(ins[k]) for k in names))
    args = {k: _t(v).requires_grad_() for k, v in ins.items()}
    h0 = tuple(args[k] for k in "cnhm") if carry else None
    y, (c, n, h, m) = tx.slstm_scan(args["gx"], args["r"], hn, h0)
    loss = (y * _t(w)).sum() + (c * _t(wc)).sum() + m.sum()
    tg = torch.autograd.grad(loss, list(args.values()))
    return dict(j=[np.asarray(a) for a in jout],
                t=[a.detach().numpy() for a in (y, c, n, h, m)],
                jg=dict(zip(names, (np.asarray(g) for g in jg))),
                tg=dict(zip(names, (g.numpy() for g in tg))))


SLSTM_CASES = {"zero-state": (False, False), "carry": (False, True),
               "tie": (True, False)}


@pytest.mark.parametrize("case", list(SLSTM_CASES))
def test_slstm_scan_equals_jax(case):
    r = _slstm_run(*SLSTM_CASES[case])
    for what, got, want in zip(["y", "c", "n", "h", "m"], r["t"], r["j"]):
        assert got.shape == want.shape, what
        _close(got, want, what=what)
    for name, want in r["jg"].items():
        assert np.abs(want).max() > 0, name
        _close(r["tg"][name], want, rtol=1e-4, scale=1e-5, what=name)


def test_slstm_tie_case_tells_amax_from_max(monkeypatch):
    """The tie case discriminates: with the head maximum taken by
    ``max(dim)`` (all of a tie's gradient to one index) the port's
    gradient of the i-gate pre-activations leaves JAX's tolerance, where
    ``amax`` (``test_slstm_scan_equals_jax[tie]``) meets it."""
    monkeypatch.setattr(torch.Tensor, "amax",
                        lambda self, dim: self.max(dim=dim).values)
    r = _slstm_run(True, False)
    got, want = r["tg"]["gx"][:, :, 1], r["jg"]["gx"][:, :, 1]
    assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


def test_slstm_bf16_recurrence_equals_jax(monkeypatch):
    monkeypatch.setattr(jx, "SLSTM_BF16_RECURRENCE", True)
    monkeypatch.setattr(tx, "SLSTM_BF16_RECURRENCE", True)
    r = _slstm_run(False, True)
    for what, got, want in zip(["y", "c", "n", "h", "m"], r["t"], r["j"]):
        _close(got, want, rtol=1e-2, scale=1e-2, what=what)
    for name, want in r["jg"].items():
        _close(r["tg"][name], want, rtol=1e-2, scale=1e-2, what=name)


# --------------------------------------------------------------- blocks
def _block_run(kind, dtype):
    jcfg = jcfgs.reduced(jcfgs.get(ARCH), d_model=64)
    tcfg = tcfgs.reduced(tcfgs.get(ARCH), d_model=64)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jctx = JShardCtx(compute_dtype=jdt, param_dtype=jdt)
    tctx = TShardCtx(compute_dtype=tdt, param_dtype=tdt)
    params = _jax_init(jcfg, jctx, 1)
    p0 = jax.tree.map(lambda a: a[0, 0] if kind == "mlstm" else a[0],
                      params["groups"][kind])
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((2, SEQ, 64)), jdt)
    r = jnp.asarray(rng.standard_normal(x.shape), jdt)
    st = StepState(mode="train")
    japply = jx.mlstm_block_apply if kind == "mlstm" \
        else jx.slstm_block_apply

    def jloss(p, xx):
        y, _ = japply(p, xx, jctx, jcfg, st)
        return jnp.sum((y * r).astype(jnp.float32)), y

    # bf16 runs op by op: under jit XLA keeps bf16 intermediates in fp32
    # where the program (and the port) rounds them
    grad = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)
    (_, jy), (jgp, jgx) = (grad if dtype == "bfloat16" else jax.jit(grad))(
        p0, x)
    host = convert.flatten(jax.device_get(p0))
    tp = {k: convert.to_tensor(v).requires_grad_() for k, v in host.items()}
    tx_in = convert.to_tensor(np.asarray(x)).requires_grad_()
    tapply = tx.mlstm_block_apply if kind == "mlstm" \
        else tx.slstm_block_apply
    ty = tapply(tp, tx_in, tcfg, tctx)
    assert ty.dtype == tdt
    tr = convert.to_tensor(np.asarray(r))
    tg = torch.autograd.grad((ty * tr).float().sum(), (*tp.values(), tx_in))
    return dict(jy=np.asarray(jy, np.float32), ty=ty.detach().float().numpy(),
                jgrads={**{k: np.asarray(v, np.float32) for k, v in
                           convert.flatten(jax.device_get(jgp)).items()},
                        "x": np.asarray(jgx, np.float32)},
                tgrads={**{k: g.float().numpy() for k, g in
                           zip(tp, tg[:-1])}, "x": tg[-1].float().numpy()},
                dtypes={k: (str(v.dtype), str(tp[k].dtype))
                        for k, v in host.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_output_and_gradients_equal_jax(kind, dtype):
    r = _block_run(kind, dtype)
    fp32 = set(tx.MLSTM_FP32_LEAVES if kind == "mlstm"
               else tx.SLSTM_FP32_LEAVES)
    for name, (jd, td) in r["dtypes"].items():
        want = "float32" if name in fp32 else dtype
        assert jd == want and td == "torch." + want, name
    assert r["ty"].shape == r["jy"].shape
    assert sorted(r["tgrads"]) == sorted(r["jgrads"])
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
                    {"groups.mlstm.b_if", "groups.mlstm.w_if",
                     "groups.slstm.b_gates", "groups.slstm.r_gates",
                     "groups.slstm.w_gates"})
    assert model.n_stages == jcfg.n_layers // jcfg.ssm.slstm_every
    if size == "full":
        shape = dict((n, s) for n, s, _ in got)
        assert shape["groups.mlstm.up_v.w"] == (3, 7, 1024, 2048)
        assert shape["groups.slstm.r_gates"] == (3, 4, 4, 256, 256)
        assert sum(int(np.prod(s)) for s in shape.values()) == 314_143_912


# ---------------------------------------------------------------- model
@pytest.fixture(scope="module")
def model_pair():
    jcfg = jcfgs.reduced(jcfgs.get(ARCH))
    jctx = JShardCtx(compute_dtype=jnp.float32)
    jmodel = JModel(jcfg)
    params = _jax_init(jcfg, jctx, 0)
    batch = batch_at(DataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                                global_batch=2), 0)

    def loss_fn(p):
        loss_sum, ntok, _ = jmodel.loss(p, batch, jctx)
        return loss_sum, ntok

    (jl, jn), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
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


def test_init_draws_the_gate_biases_as_jax():
    jcfg = jcfgs.reduced(jcfgs.get(ARCH))
    params = _jax_init(jcfg, JShardCtx(param_dtype=jnp.bfloat16), 0)
    flat = convert.flatten(jax.device_get(params))
    model = TModel(tcfgs.reduced(tcfgs.get(ARCH)),
                   TShardCtx(param_dtype=torch.bfloat16), device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    p = dict(model.named_parameters())
    for name in ("groups.mlstm.b_if", "groups.slstm.b_gates"):
        assert p[name].dtype == torch.float32
        np.testing.assert_array_equal(p[name].detach().numpy(),
                                      np.asarray(flat[name]), err_msg=name)
    for name in ("groups.mlstm.ln", "groups.slstm.ln2"):
        assert torch.equal(p[name], torch.ones_like(p[name]))
    r = p["groups.slstm.r_gates"]
    assert r.std().item() == pytest.approx(r.shape[-1] ** -0.5, rel=0.1)
