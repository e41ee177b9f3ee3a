"""The vlm family (``qwen2-vl-7b``) of the port against the JAX package's.

* ``mrope_sections`` for every even head dim from 8 to 256, and
  ``apply_mrope`` with three distinct position streams (an image block,
  then text) in fp32 and bf16, against ``repro.models.layers``: fp32 to
  1e-6 of the largest entry (the angles are the same fp32 products),
  bf16 to within one bf16 unit of the output.
* The reduced arch's leaves, and its loss and every gradient from the same
  parameters and batch, through the ``embeds`` input and through the
  tokens, in fp32 (loss ``rtol=1e-5``, gradients ``rtol=1e-4`` plus 1e-5
  of the largest entry) and bf16 (loss ``rtol=5e-2``, gradients within a
  relative L2 difference of 5e-2), under ``remat="none"`` and
  ``"full"`` (the same bits).  Through ``embeds`` the embedding table is
  not read and its gradient is zero in both packages.
* ``param_count`` is JAX's: 7,615,487,488.
* ``launch/inputs.py``'s ``meta`` tensors against JAX's
  ``ShapeDtypeStruct``s and ``PartitionSpec``s for every arch and shape.
* The overlapped layout of the reduced and the full arch against JAX's
  ``overlap.build_layout``, and the overlapped one-rank step against the
  classic one (the same update in fp32 to 1e-6).
* ``vlm_positions`` has three distinct streams, and a vlm batch without
  ``mrope_positions`` raises ``KeyError`` naming it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.configs import shapes as jshapes
from repro.launch import inputs as jinputs
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.models.layers import ShardCtx as JShardCtx
from repro_torch import convert
from repro_torch.configs import base as tcfgs
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import inputs as tinputs
from repro_torch.models import layers as tlayers
from repro_torch.models.layers import ShardCtx as TShardCtx
from repro_torch.models.model import Model as TModel

ARCH = "qwen2-vl-7b"
FULL_COUNT = 7_615_487_488
B, S = 2, 24
IMAGE, GRID = 16, 4
BF16_GRAD = 5e-2


def _close(got, want, rtol=1e-5, scale=1e-6, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()),
                               err_msg=what)


def _rel(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _cfgs():
    return jcfgs.reduced(jcfgs.get(ARCH)), tcfgs.reduced(tcfgs.get(ARCH))


def _positions(b=B, s=S):
    return tinputs.vlm_positions(b, s, IMAGE, GRID).numpy()


# ---------------------------------------------------------------- M-RoPE
def test_mrope_sections_equal_jax():
    for hd in range(8, 258, 2):
        assert tlayers.mrope_sections(hd) == jlayers.mrope_sections(hd)
    assert tlayers.mrope_sections(128) == (16, 24, 24)


def test_vlm_positions_have_three_distinct_streams():
    pos = _positions()
    assert pos.shape == (3, B, S)
    t, h, w = pos[:, 0]
    assert (t[:IMAGE] == 0).all()
    assert list(h[:IMAGE]) == [i // GRID for i in range(IMAGE)]
    assert list(w[:IMAGE]) == [i % GRID for i in range(IMAGE)]
    assert (t[IMAGE:] == h[IMAGE:]).all() and (h[IMAGE:] == w[IMAGE:]).all()
    assert t[IMAGE] == GRID and list(np.diff(t[IMAGE:])) == [1] * (
        S - IMAGE - 1)
    assert not (t == h).all() and not (h == w).all()
    assert (pos[:, 1] == pos[:, 0]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_equals_jax(dtype):
    rng = np.random.default_rng(3)
    hd, theta = 32, 1e6
    x = rng.standard_normal((B, S, 4, hd)).astype(np.float32)
    pos = _positions()
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = np.asarray(jlayers.apply_mrope(jx, jnp.asarray(pos), theta),
                      np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tlayers.apply_mrope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    if dtype == "float32":
        _close(got, want, rtol=1e-6, scale=1e-6)
    else:
        # one bf16 unit of the output: the products round once in each
        assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    # the streams matter: the plain rotation by the text stream differs
    rope = tlayers.apply_rope(tx, torch.from_numpy(pos[0]), theta)
    assert not torch.equal(rope.float(), torch.from_numpy(got))


# ---------------------------------------------------------------- model
def _jax_init(jcfg, jctx, seed):
    return jax.jit(lambda k: JModel(jcfg).init(k, jctx)[0])(
        jax.random.key(seed))


def _batch(jcfg, embeds: bool):
    rng = np.random.default_rng(7)
    batch = {"labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
             "mrope_positions": _positions().astype(np.int32)}
    if embeds:
        batch["embeds"] = rng.standard_normal(
            (B, S, jcfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, jcfg.vocab, (B, S)).astype(
            np.int32)
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


def test_leaf_names_shapes_and_order_equal_jax():
    jcfg, tcfg = _cfgs()
    flat = convert.flatten(jax.device_get(_jax_init(jcfg, JShardCtx(), 0)))
    model = TModel(tcfg, TShardCtx(), device="meta")
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == \
        [(n, tuple(a.shape)) for n, a in flat.items()]
    shapes, _ = JModel(jcfgs.get(ARCH)).abstract_init(JShardCtx())
    full = TModel(tcfgs.get(ARCH), TShardCtx(), device="meta")
    assert [(n, tuple(p.shape)) for n, p in full.named_parameters()] == [
        (".".join(str(k.key) for k in path), tuple(leaf.shape))
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert full.stacks == (("blocks.", 28),)


def test_param_count_equals_jax():
    ja, ta = jcfgs.get(ARCH), tcfgs.get(ARCH)
    assert ta.param_count() == ja.param_count() == FULL_COUNT
    assert ta.active_param_count() == ja.active_param_count() == FULL_COUNT


@pytest.fixture(scope="module",
                params=[("float32", True), ("float32", False),
                        ("bfloat16", True)],
                ids=["fp32-embeds", "fp32-tokens", "bf16-embeds"])
def model_pair(request):
    """JAX's and the port's loss and gradients of the reduced arch from
    the same fp32 parameters and batch, computing in the given dtype; the
    port under ``remat="none"`` and ``"full"``."""
    cdt, embeds = request.param
    jcfg, tcfg = _cfgs()
    jctx = JShardCtx(compute_dtype=jnp.dtype(cdt))
    jmodel = JModel(jcfg)
    params = _jax_init(jcfg, jctx, 0)
    batch = _batch(jcfg, embeds)

    def loss_fn(p):
        loss_sum, ntok, _ = jmodel.loss(p, batch, jctx)
        return loss_sum, ntok

    grad = jax.value_and_grad(loss_fn, has_aux=True)
    (jl, jn), jg = (grad if cdt == "bfloat16" else jax.jit(grad))(params)
    out = dict(dtype=cdt, embeds=embeds, j=(float(jl), int(jn)),
               jgrads=convert.flatten(jax.device_get(jg)))
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tcfg, plan=dataclasses.replace(
            tcfg.plan, remat=remat))
        tmodel = TModel(cfg, TShardCtx(compute_dtype=getattr(torch, cdt)),
                        device="cpu")
        convert.load_params(tmodel, jax.device_get(params))
        tl, tn, ta = tmodel.loss(_to_torch(batch))
        tg = torch.autograd.grad(tl, list(tmodel.parameters()),
                                 allow_unused=True, materialize_grads=True)
        out[remat] = dict(t=(tl.item(), int(tn), ta.item()),
                          tgrads=dict(zip([n for n, _ in
                                           tmodel.named_parameters()], tg)))
    return out


def test_model_loss_equals_jax(model_pair):
    (jl, jn), (tl, tn, ta) = model_pair["j"], model_pair["none"]["t"]
    assert tn == jn == B * S
    assert ta == 0.0
    rtol = 1e-5 if model_pair["dtype"] == "float32" else BF16_GRAD
    np.testing.assert_allclose(tl, jl, rtol=rtol)


def test_model_gradients_equal_jax(model_pair):
    tgrads = model_pair["none"]["tgrads"]
    assert list(tgrads) == list(model_pair["jgrads"])
    for name, g in tgrads.items():
        want = model_pair["jgrads"][name]
        if name == "embed.table" and model_pair["embeds"]:
            # the table is not read: zero in both packages
            assert not np.abs(want).any() and not g.abs().any()
            continue
        assert np.abs(want).max() > 0, name       # every leaf is live
        if model_pair["dtype"] == "float32":
            _close(g.numpy(), want, rtol=1e-4, scale=1e-5, what=name)
        else:
            assert _rel(g.float().numpy(), want) <= BF16_GRAD, (
                name, _rel(g.float().numpy(), want))


def test_remat_gives_the_same_bits(model_pair):
    a, b = model_pair["none"], model_pair["full"]
    assert a["t"] == b["t"]
    for name, g in a["tgrads"].items():
        assert torch.equal(g, b["tgrads"][name]), name


def test_loss_without_mrope_positions_names_them():
    _, tcfg = _cfgs()
    model = TModel(tcfg, TShardCtx(compute_dtype=torch.float32),
                   device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    batch = _to_torch(_batch(jcfgs.reduced(jcfgs.get(ARCH)), True))
    del batch["mrope_positions"]
    with pytest.raises(KeyError, match="mrope_positions"):
        model.loss(batch)


# ---------------------------------------------------------------- inputs
@pytest.mark.parametrize("name", tcfgs.names())
def test_inputs_equal_jax(name):
    """Every input's shape and dtype, and its split dim against the dim
    of JAX's ``PartitionSpec`` that names the DP axes."""
    ja, ta = jcfgs.get(name), tcfgs.get(name)
    for shape_name in tshapes.SHAPES:
        ts_, js = tshapes.SHAPES[shape_name], jshapes.SHAPES[shape_name]
        for dp in ((), ("data",), ("pod", "data")):
            for cp in (False, True):
                calls = [(tinputs.train_inputs(ta, ts_, dp),
                          jinputs.train_inputs(ja, js, dp)),
                         (tinputs.prefill_inputs(ta, ts_, dp, cp),
                          jinputs.prefill_inputs(ja, js, dp, cp)),
                         (tinputs.decode_inputs(ta, ts_, dp, cp),
                          jinputs.decode_inputs(ja, js, dp, cp))]
                for (tt, tsplit), (jt, jspec) in calls:
                    assert list(tt) == list(jt) == list(tsplit)
                    for k, v in tt.items():
                        assert v.device.type == "meta"
                        assert tuple(v.shape) == jt[k].shape, (name, k)
                        assert str(v.dtype).removeprefix("torch.") == \
                            str(jt[k].dtype), (name, k)
                        dims = [i for i, e in enumerate(jspec[k])
                                if e is not None]
                        assert tsplit[k] == (dims[0] if dims else None), (
                            name, k, jspec[k])
    vlm, _ = tinputs.train_inputs(tcfgs.get(ARCH), tshapes.SHAPES[
        "train_4k"], ("data",))
    assert tuple(vlm["embeds"].shape) == (256, 4096, 3584)
    assert tuple(vlm["mrope_positions"].shape) == (3, 256, 4096)


# ------------------------------------------------------------- overlap
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_overlap_layout_matches_jax(full):
    from repro.launch.mesh import make_local_mesh
    from repro.train import overlap as jov
    from repro.train import train_step as jts
    from repro_torch.train import overlap as tov
    jarch, tarch = jcfgs.get(ARCH), tcfgs.get(ARCH)
    if not full:
        jarch, tarch = _cfgs()
    bucket_mb = 25 if full else 0.125
    want = jov.build_layout(jts.build(jarch, make_local_mesh(),
                                      bucket_mb=bucket_mb, overlap=True,
                                      dp_mode="ddp", zero1=True))
    got = tov.layout_for_model(TModel(tarch, TShardCtx(
        param_dtype=torch.bfloat16), device="meta"), bucket_mb)
    for field in ("n_elements", "bucket_elems", "n_buckets", "sizes",
                  "leaf_sizes", "leaf_bucket"):
        assert getattr(got.layout, field) == getattr(want.layout, field)
    assert (got.n_stages, got.bucket_ready) == (want.n_stages,
                                                want.bucket_ready)
    assert [(s.key, s.n_layers, s.n_leaves) for s in got.stacks] == [
        (s.key, s.n_layers, s.n_leaves) for s in want.stacks]


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


def test_overlapped_step_equals_the_classic_step(own_world):
    """One rank, fp32, ``dp_mode="ddp"`` (the overlapped step refuses
    FSDP): the overlapped step (the ``embeds`` first stage, M-RoPE in
    every block) against the classic step, uncompressed, after two
    steps."""
    from repro_torch.train import overlap as tov
    from repro_torch.train import train_step as tts
    _, tcfg = _cfgs()
    batch = _batch(jcfgs.reduced(jcfgs.get(ARCH)), True)
    out = {}
    for sched in ("classic", "overlap"):
        setup = tts.build(tcfg, "cpu", dp_mode="ddp", zero1=False,
                          bucket_mb=0.125, overlap=sched == "overlap",
                          remat="full")
        setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                              compute_dtype=torch.float32)
        state = tts.init_state(setup)
        step = tov.make_step(setup, "overlap") if sched == "overlap" \
            else tts.make_step(setup)
        for _ in range(2):
            state, m = step(state, batch, 1e-3)
        out[sched] = ([p.detach().clone() for p in setup.model.parameters()],
                      m["loss"].item())
    (pc, lc), (po, lo) = out["classic"], out["overlap"]
    np.testing.assert_allclose(lo, lc, rtol=1e-6)
    for a, b in zip(po, pc):
        _close(a.numpy(), b.numpy(), rtol=1e-6, scale=1e-6)
