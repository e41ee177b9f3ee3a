"""The port's dense decoder against the JAX package's on the reduced
``tinyllama-1.1b`` (2 layers, d_model 128, vocab 512) from carried-over
parameters, computed in fp32 (``ShardCtx(compute_dtype=float32)`` on both
sides): loss and every gradient leaf; and the bucket layout and order.

Tolerances: loss ``rtol=1e-5``; gradients ``rtol=1e-4`` plus an absolute
``1e-5`` of the leaf's largest entry (fp32, sums in different orders
through two layers and the loss; the gradient of the loss sum reaches 14
on the embedding); the bucket layout and the raveled parameters exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.core import bucketing as jbucketing
from repro.data.synthetic import DataConfig, batch_at
from repro.models import Model as JModel
from repro.models.layers import ShardCtx as JShardCtx
from repro_torch import convert
from repro_torch.configs import base as tcfgs
from repro_torch.core import bucketing as tbucketing
from repro_torch.models.layers import ShardCtx as TShardCtx
from repro_torch.models.model import Model as TModel

BUCKET_MB = 0.5                  # 4 buckets, the last one short


def _atol(ref):
    return 1e-5 * float(np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    jcfg = jcfgs.reduced(jcfgs.get("tinyllama-1.1b"))
    jctx = JShardCtx(compute_dtype=jnp.float32)
    jmodel = JModel(jcfg)
    params, _ = jmodel.init(jax.random.key(0), jctx)
    batch = batch_at(DataConfig(vocab=jcfg.vocab, seq_len=32,
                                global_batch=2), 0)

    def loss_fn(p):
        loss_sum, ntok, _ = jmodel.loss(p, batch, jctx)
        return loss_sum, ntok

    (jloss, jntok), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    tmodel = TModel(tcfgs.reduced(tcfgs.get("tinyllama-1.1b")),
                    TShardCtx(compute_dtype=torch.float32), device="cpu")
    host = jax.device_get(params)
    convert.load_params(tmodel, host)
    tloss, tntok, taux = tmodel.loss({k: torch.from_numpy(v).long()
                                      for k, v in batch.items()})
    assert taux.item() == 0.0           # the dense family has no MoE loss
    tgrads = torch.autograd.grad(tloss, list(tmodel.parameters()))
    return dict(params=params, host=host, jloss=jloss, jntok=jntok,
                jgrads=jax.device_get(jgrads), tmodel=tmodel, tloss=tloss,
                tntok=tntok, tgrads=tgrads)


def test_parameter_names_shapes_and_order_match_jax(pair):
    flat = convert.flatten(pair["host"])
    names = [n for n, _ in pair["tmodel"].named_parameters()]
    assert names == list(flat)
    leaves = jax.tree_util.tree_leaves(pair["host"])
    assert [tuple(p.shape) for p in pair["tmodel"].parameters()] == \
        [tuple(x.shape) for x in leaves]


def test_loss_matches_jax_fp32(pair):
    assert int(pair["tntok"]) == int(pair["jntok"]) == 64
    np.testing.assert_allclose(pair["tloss"].item(), float(pair["jloss"]),
                               rtol=1e-5)


def test_gradients_match_jax_fp32(pair):
    flat = convert.flatten(pair["jgrads"])
    for (name, _), g in zip(pair["tmodel"].named_parameters(),
                            pair["tgrads"]):
        np.testing.assert_allclose(g.numpy(), flat[name], rtol=1e-4,
                                   atol=_atol(flat[name]), err_msg=name)


def test_bucket_layout_and_order_match_jax(pair):
    jl = jbucketing.layout_for(pair["params"], BUCKET_MB)
    tl = tbucketing.layout_for(list(pair["tmodel"].parameters()), BUCKET_MB)
    assert (tl.n_elements, tl.bucket_elems, tl.n_buckets, tl.sizes) == \
        (jl.n_elements, jl.bucket_elems, jl.n_buckets, jl.sizes)
    assert tl.n_buckets == 4 and tl.last_elems < tl.bucket_elems
    assert tl.dtype == torch.float32 and jl.dtype == jnp.float32
    with torch.no_grad():
        tb = tbucketing.to_buckets(list(pair["tmodel"].parameters()), tl)
    jb = jbucketing.to_buckets(pair["params"], jl)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # gradients ride the same order: the buckets PowerSGD sees agree
    tgb = tbucketing.to_buckets(pair["tgrads"], tl)
    jgb = jbucketing.to_buckets(pair["jgrads"], jl)
    for a, b in zip(tgb, jgb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=_atol(np.asarray(b)))


def test_from_buckets_inverts_to_buckets(pair):
    leaves = list(pair["tmodel"].parameters())
    tl = tbucketing.layout_for(leaves, BUCKET_MB)
    with torch.no_grad():
        back = tbucketing.from_buckets(tbucketing.to_buckets(leaves, tl),
                                       leaves, tl)
    for a, b in zip(back, leaves):
        assert a.shape == b.shape and torch.equal(a, b)


def test_full_size_parameter_count():
    """The full tinyllama-1.1b: 1,100,048,384 parameters in 168 buckets of
    6,553,600 elements (the last holds 5,597,184) — the main path's shapes,
    counted on the ``meta`` device."""
    model = TModel(tcfgs.get("tinyllama-1.1b"), device="meta")
    leaves = list(model.parameters())
    assert sum(p.numel() for p in leaves) == 1_100_048_384
    lay = tbucketing.layout_for(leaves, 25)
    assert (lay.n_buckets, lay.bucket_elems, lay.last_elems) == \
        (168, 6_553_600, 5_597_184)
