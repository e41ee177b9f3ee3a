"""The port's MoE layer (``repro_torch.models.moe``) and the MoE and qk-norm
models against the JAX package's (``repro.models.moe``,
``repro.models.model``), computed in fp32 on both sides
(``ShardCtx(compute_dtype=float32)``) from carried-over parameters and the
same numpy inputs.

* ``capacity`` equals JAX's on a sweep.
* ``_route``, ``_dispatch_indices`` and ``moe_apply`` on layer 0 of the
  reduced ``qwen2-moe-a2.7b`` (a shared expert behind a sigmoid gate) and
  the reduced ``arctic-480b`` (a dense residual), each with capacity
  factor 4 (no drops) and 0.25 (drops): the expert ids, slots and keep
  mask exactly (routing is discontinuous, so these come first), then the
  probabilities, logits, output and load-balancing loss, and the
  gradients of ``sum(y * r) + aux`` with respect to every parameter and
  ``x``.
* The leaf names, shapes, dtypes (the fp32 router and shared gate under
  bf16 parameters) and order of both models equal JAX's
  ``abstract_init``, and ``convert.load_params`` carries a bf16 JAX tree
  over bit for bit, each leaf in its own dtype.
* ``Model.loss`` (loss sum, tokens, the mean load-balancing loss) and the
  gradients of ``loss + aux`` for the reduced ``qwen2-moe-a2.7b``,
  ``arctic-480b`` and ``qwen3-32b`` (qk-norm).
* The classic step's metrics carry ``moe_aux``: 0 for the dense family,
  the mean load-balancing loss for MoE.

Tolerances: fp32 with sums in other orders.  Probabilities, logits and
outputs ``rtol=1e-5`` plus an absolute ``1e-6`` of the largest entry;
losses ``rtol=1e-5``; gradients ``rtol=1e-4`` plus an absolute ``1e-5``
of the leaf's largest entry (``tests/test_torch_model.py``'s rule).
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
from repro.models import moe as jmoe
from repro.models.layers import ShardCtx as JShardCtx
from repro_torch import convert
from repro_torch.configs import base as tcfgs
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import ShardCtx as TShardCtx
from repro_torch.models.model import Model as TModel

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
#: capacity factor -> does the layer drop picks at B x S = 2 x 16?
FACTORS = {4.0: False, 0.25: True}
B, S = 2, 16


def _close(got, want, rtol=1e-5, scale=1e-6, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()),
                               err_msg=what)


def _cfgs(arch, factor):
    j = jcfgs.reduced(jcfgs.get(arch))
    j = dataclasses.replace(j, moe=dataclasses.replace(
        j.moe, capacity_factor=factor))
    t = tcfgs.reduced(tcfgs.get(arch))
    t = dataclasses.replace(t, moe=dataclasses.replace(
        t.moe, capacity_factor=factor))
    return j, t


@pytest.fixture(scope="module", params=[(a, f) for a in ARCHS
                                        for f in FACTORS],
                ids=lambda p: f"{p[0]}-cf{p[1]}")
def layer(request):
    """Layer 0's MoE parameters from JAX's init, an input and a cotangent
    from numpy; both sides' routing, outputs and gradients."""
    arch, factor = request.param
    jcfg, tcfg = _cfgs(arch, factor)
    jctx = JShardCtx(compute_dtype=jnp.float32)
    params, _ = JModel(jcfg).init(jax.random.key(1), jctx)
    p0 = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    rng = np.random.default_rng(20)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    mc = jcfg.moe
    t = B * S
    e_pad = jmoe.pad_experts(mc.n_experts, 1)
    cap = jmoe.capacity(t, mc.top_k, e_pad, 1, mc.capacity_factor)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jctx, jcfg)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p0, jnp.asarray(x))
    jprobs, jtop, jlogits = jmoe._route(p0["router"],
                                        jnp.asarray(x.reshape(t, -1)), mc,
                                        e_pad)
    jdisp = jmoe._dispatch_indices(jtop, e_pad, cap)

    host = convert.flatten(jax.device_get(p0), "moe.")
    tp = {k: convert.to_tensor(v).requires_grad_() for k, v in host.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tctx = TShardCtx(compute_dtype=torch.float32)
    ty, taux = tmoe.moe_apply(tp, tx, tcfg, tctx)
    tg = torch.autograd.grad((ty * torch.from_numpy(r)).sum() + taux,
                             (*tp.values(), tx))
    with torch.no_grad():
        tprobs, ttop, tlogits = tmoe._route(tp["moe.router"],
                                            tx.reshape(t, -1), tcfg.moe,
                                            e_pad)
        tdisp = tmoe._dispatch_indices(ttop, e_pad, cap)
    return dict(
        factor=factor, cap=cap, jy=np.asarray(jy), jaux=float(jaux),
        jgrads={**convert.flatten(jax.device_get(jgp), "moe."),
                "x": np.asarray(jgx)},
        jroute=[np.asarray(a) for a in (jprobs, jtop, jlogits)],
        jdisp=[np.asarray(a) for a in jdisp], ty=ty.detach().numpy(),
        taux=taux.item(),
        tgrads={**{k: g.numpy() for k, g in zip(tp, tg[:-1])},
                "x": tg[-1].numpy()},
        troute=[a.numpy() for a in (tprobs, ttop, tlogits)],
        tdisp=[a.numpy() for a in tdisp], names=list(tp))


def test_capacity_equals_jax():
    for t in (1, 7, 32, 2048, 8192):
        for k in (1, 2, 4):
            for e in (4, 60, 128):
                for f in (0.25, 1.0, 1.25, 4.0):
                    assert tmoe.capacity(t, k, e, 1, f) == \
                        jmoe.capacity(t, k, e, 1, f)
    assert tmoe.pad_experts(60, 1) == jmoe.pad_experts(60, 1) == 60


def test_routing_and_slots_equal_jax(layer):
    """Expert ids, slots and the keep mask exactly; the keep mask drops
    picks exactly where the capacity factor says it must."""
    (jp, jtop, jlog), (tp, ttop, tlog) = layer["jroute"], layer["troute"]
    np.testing.assert_array_equal(ttop, jtop)
    for got, want in zip(layer["tdisp"], layer["jdisp"]):
        np.testing.assert_array_equal(got, want)
    keep = layer["tdisp"][2]
    assert (not keep.all()) == FACTORS[layer["factor"]]
    slots = layer["tdisp"][1]
    assert slots.min() == 0 and (slots[keep] < layer["cap"]).all()
    _close(tp, jp, what="probs")
    _close(tlog, jlog, what="logits")


def test_moe_apply_output_and_aux_equal_jax(layer):
    _close(layer["ty"], layer["jy"], what="y")
    np.testing.assert_allclose(layer["taux"], layer["jaux"], rtol=1e-5)


def test_moe_apply_gradients_equal_jax(layer):
    assert sorted(layer["tgrads"]) == sorted(layer["jgrads"])
    for name, want in layer["jgrads"].items():
        _close(layer["tgrads"][name], want, rtol=1e-4, scale=1e-5,
               what=name)


def test_moe_backward_has_no_index_put_accumulate():
    """The token gather and the combine are an expand and a sum over a
    ``(T, k, d)`` view: no advanced-indexing or scatter-add node, whose
    CUDA backward adds many values into one place in any order.  The slot
    write is an ``index_copy`` and the slot read an ``index_select``,
    whose backward adds into each slot its one kept value and zeros."""
    _, tcfg = _cfgs("qwen2-moe-a2.7b", 1.25)
    model = TModel(tcfg, TShardCtx(compute_dtype=torch.float32),
                   device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    p = {n[len("blocks."):]: t[0] for n, t in model.named_parameters()
         if n.startswith("blocks.moe.")}
    x = torch.randn(B, S, tcfg.d_model, requires_grad=True)
    y, aux = tmoe.moe_apply(p, x, tcfg, model.ctx)
    seen, stack = set(), [y.grad_fn, aux.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    kinds = {type(fn).__name__ for fn in seen}
    assert {"IndexCopyBackward0", "IndexSelectBackward0",
            "ExpandBackward0"} <= kinds
    assert not kinds & {"IndexBackward0", "IndexPutBackward0",
                        "ScatterAddBackward0", "IndexAddBackward0"}


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_names_shapes_dtypes_and_order_equal_jax(arch):
    """Under bf16 parameters (ZeRO-1's working copies, arctic's plan) the
    router and the shared gate stay fp32, as JAX draws them."""
    jcfg = jcfgs.reduced(jcfgs.get(arch))
    for dtype in ("float32", "bfloat16"):
        shapes, _ = JModel(jcfg).abstract_init(
            JShardCtx(param_dtype=jnp.dtype(dtype)))
        want = [(".".join(str(k.key) for k in path), tuple(leaf.shape),
                 str(leaf.dtype))
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    shapes)[0]]
        model = TModel(tcfgs.reduced(tcfgs.get(arch)),
                       TShardCtx(param_dtype=getattr(torch, dtype)),
                       device="meta")
        got = [(n, tuple(p.shape), str(p.dtype).removeprefix("torch."))
               for n, p in model.named_parameters()]
        assert got == want
        assert [p for _, p in model.named_parameters()] == \
            list(model.parameters())
    fp32 = {n for n, _, d in got if d == "float32"}
    assert fp32 == ({"blocks.moe.router", "blocks.moe.shared_gate"}
                    if arch == "qwen2-moe-a2.7b" else {"blocks.moe.router"})


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_each_leaf_in_its_own_dtype(arch):
    """A JAX tree drawn under bf16 parameters (the fp32 router and shared
    gate included) loads into the port's bf16 model bit for bit."""
    jcfg = jcfgs.reduced(jcfgs.get(arch))
    params, _ = JModel(jcfg).init(jax.random.key(2),
                                  JShardCtx(param_dtype=jnp.bfloat16))
    flat = convert.flatten(jax.device_get(params))
    model = TModel(tcfgs.reduced(tcfgs.get(arch)),
                   TShardCtx(param_dtype=torch.bfloat16), device="cpu")
    convert.load_params(model, jax.device_get(params))
    for name, p in model.named_parameters():
        want = convert.to_tensor(flat[name])
        assert p.dtype == want.dtype, name
        bits = torch.int16 if p.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(p.detach().view(bits), want.view(bits)), name


@pytest.fixture(scope="module", params=[*ARCHS, "qwen3-32b"])
def model_pair(request):
    arch = request.param
    jcfg = jcfgs.reduced(jcfgs.get(arch))
    jctx = JShardCtx(compute_dtype=jnp.float32)
    jmodel = JModel(jcfg)
    params, _ = jmodel.init(jax.random.key(0), jctx)
    batch = batch_at(DataConfig(vocab=jcfg.vocab, seq_len=32,
                                global_batch=2), 0)

    def loss_fn(p):
        loss_sum, ntok, aux = jmodel.loss(p, batch, jctx)
        return loss_sum + aux, (loss_sum, ntok, aux)

    (_, (jl, jn, ja)), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tmodel = TModel(tcfgs.reduced(tcfgs.get(arch)),
                    TShardCtx(compute_dtype=torch.float32), device="cpu")
    convert.load_params(tmodel, jax.device_get(params))
    tl, tn, ta = tmodel.loss({k: torch.from_numpy(v).long()
                              for k, v in batch.items()})
    tg = torch.autograd.grad(tl + ta, list(tmodel.parameters()))
    return dict(arch=arch, j=(float(jl), int(jn), float(ja)),
                t=(tl.item(), int(tn), ta.item()),
                jgrads=convert.flatten(jax.device_get(jg)),
                tgrads=dict(zip([n for n, _ in tmodel.named_parameters()],
                                tg)))


def test_model_loss_equals_jax(model_pair):
    (jl, jn, ja), (tl, tn, ta) = model_pair["j"], model_pair["t"]
    assert tn == jn == 64
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    if model_pair["arch"] == "qwen3-32b":
        assert ta == ja == 0.0
    else:
        assert ta > 0
        np.testing.assert_allclose(ta, ja, rtol=1e-5)


def test_model_gradients_equal_jax(model_pair):
    assert list(model_pair["tgrads"]) == list(model_pair["jgrads"])
    if model_pair["arch"] == "qwen3-32b":
        assert "blocks.attn.q_norm.scale" in model_pair["tgrads"]
    for name, g in model_pair["tgrads"].items():
        _close(g.numpy(), model_pair["jgrads"][name], rtol=1e-4, scale=1e-5,
               what=name)


@pytest.fixture(scope="module")
def world():
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{mesh_mod.free_port()}",
        rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
def test_step_metrics_carry_moe_aux(world, arch):
    """The classic step reports ``moe_aux``, as JAX's ``train_metrics``
    does: 0 for the dense family, else the mean load-balancing loss of the
    step's forward."""
    from repro_torch.train import train_step as tts
    cfg = tcfgs.reduced(tcfgs.get(arch))
    setup = tts.build(cfg, "cpu", dp_mode="ddp", zero1=False)
    state = tts.init_state(setup)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=16,
                                global_batch=2), 0)
    with torch.no_grad():
        _, _, want = setup.model.loss({k: torch.from_numpy(v).long()
                                       for k, v in batch.items()})
    _, m = tts.make_step(setup)(state, batch, 1e-3)
    assert set(m) == {"loss", "tokens", "grad_norm", "moe_aux"}
    assert m["moe_aux"].dtype == torch.float32
    if arch == "tinyllama-1.1b":
        assert m["moe_aux"].item() == 0.0
    else:
        assert m["moe_aux"].item() == pytest.approx(want.item(), rel=1e-6)
