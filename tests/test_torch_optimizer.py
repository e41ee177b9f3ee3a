"""SGD with momentum and Adafactor: the port against the JAX package.

* The update alone: the same parameter tree (a stacked ``(L, rows, cols)``
  leaf, matrices, vectors; numpy draws from a seed) and the same three
  gradients through ``optimizer.make(name)`` of both packages, with and
  without the global-norm clip.  Parameters and every state leaf (AdamW
  ``m``/``v``, SGDM ``m``, Adafactor's row and column statistics or full
  second moment) ``rtol=1e-5, atol=1e-7``: the arithmetic is JAX's, in
  its order, in fp32, and only the sums (norms, row and column means) add
  in another order.  ``t`` equal.
* Three replicated training steps (``zero1=False``, fp32 parameters) of
  the reduced ``tinyllama-1.1b`` on one rank from the same parameters and
  batches, against JAX's ``make_step``, both computing in fp32 (as
  ``tests/test_torch_zero1.py`` explains, bf16 compute alone moves the
  gradients by 1-1.5%): loss and grad norm ``rtol=1e-5``, parameters
  ``rtol=1e-6, atol=1e-7`` (measured: at most one fp32 ulp apart).
* ZeRO-1 shards flat AdamW state: ``build`` refuses another optimizer
  there (JAX's step fails its assertion at the first call).
* The state trees survive a checkpoint: saved by the port and read back by
  the port and by JAX's ``ckpt.restore`` against ``abstract_state``, bit
  for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.checkpoint import checkpoint as jckpt
from repro.checkpoint.manager import abstract_state as jabstract
from repro.configs import base as jcfgs
from repro.data.synthetic import DataConfig, batch_at
from repro.launch.mesh import make_local_mesh
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import base as tcfgs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

LR = 1e-3
STEPS = 3
SHAPES = {"blocks": {"w": (3, 8, 12), "scale": (3, 12)},
          "embed": {"table": (16, 8)}, "norm": {"scale": (8,)}}


@pytest.fixture(scope="module", autouse=True)
def world():
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{mesh_mod.free_port()}",
        rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _tree(rng, scale=1.0):
    return jax.tree.map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
        SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def _leaves(tree):
    return list(convert.flatten(tree).values())


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
@pytest.mark.parametrize("name", ["sgdm", "adafactor", "adamw"])
def test_update_matches_jax(name, clip):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(STEPS)]
    cfg = dict(name=name, grad_clip=clip)
    jo = jopt.make(name, jopt.OptConfig(**cfg),
                   jax.tree.map(lambda _: P(), params))
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    to = topt.make(name, topt.OptConfig(**cfg))
    tp = [torch.from_numpy(a.copy()) for a in _leaves(params)]
    ts_ = to.init(tp)
    for g in grads:
        jp, js, jm = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                               jnp.float32(LR))
        tp, ts_, tm = to.update([torch.from_numpy(a) for a in _leaves(g)],
                                ts_, tp, LR)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
    for w, t in zip(_leaves(jax.device_get(jp)), tp):
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-7)
    js = jax.device_get(js)
    assert ts_["t"] == int(js["t"]) == STEPS
    for k in js:
        if k == "t":
            continue
        want = list(convert.flatten(js[k]).values())
        got = [t for x in ts_[k] for t in (
            [x[f] for f in sorted(x)] if isinstance(x, dict) else [x])]
        assert len(got) == len(want), k
        for w, t in zip(want, got):
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


# ------------------------------------------------------------ train steps
OVERRIDES = dict(zero1=False, compression="none")


def _batches():
    cfg = DataConfig(vocab=512, seq_len=32, global_batch=4)
    return [batch_at(cfg, s) for s in range(STEPS)]


@pytest.mark.parametrize("name", ["sgdm", "adafactor"])
def test_three_replicated_steps_match_jax(name):
    jcfg = jcfgs.reduced(jcfgs.get("tinyllama-1.1b"))
    jsetup = jts.build(jcfg, make_local_mesh(), optimizer=name, **OVERRIDES)
    jsetup.ctx = dataclasses.replace(jsetup.ctx, compute_dtype=jnp.float32)
    state = jts.init_state(jsetup, jax.random.key(0))
    start = jax.device_get(state["params"])
    step = jts.make_step(jsetup)(_batches()[0])
    jm = []
    for b in _batches():
        state, m = step(state, b, jnp.float32(LR))
        jm.append(jax.device_get(m))
    jparams = convert.flatten(jax.device_get(state["params"]))

    setup = tts.build(tcfgs.reduced(tcfgs.get("tinyllama-1.1b")), "cpu",
                      optimizer=name, **OVERRIDES)
    assert setup.opt_cfg.name == name
    setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                          compute_dtype=torch.float32)
    tstate = tts.init_state(setup)
    convert.load_params(setup.model, start)
    tstep = tts.make_step(setup)
    for b, want in zip(_batches(), jm):
        tstate, m = tstep(tstate, b, LR)
        np.testing.assert_allclose(m["loss"].item(), float(want["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(want["grad_norm"]), rtol=1e-5)
    assert tstate["opt"]["t"] == STEPS
    for n, p in setup.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n],
                                   rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("name", ["sgdm", "adafactor"])
def test_zero1_refuses_another_optimizer(name):
    cfg = tcfgs.reduced(tcfgs.get("tinyllama-1.1b"))
    with pytest.raises(ValueError, match="flat AdamW"):
        tts.build(cfg, "cpu", optimizer=name)
    jsetup = jts.build(jcfgs.reduced(jcfgs.get("tinyllama-1.1b")),
                       make_local_mesh(), optimizer=name)
    state = jts.init_state(jsetup, jax.random.key(0))
    b = _batches()[0]
    with pytest.raises(AssertionError, match="flat AdamW"):
        jts.make_step(jsetup)(b)(state, b, jnp.float32(LR))


@pytest.mark.parametrize("name", ["sgdm", "adafactor"])
def test_state_tree_survives_the_checkpoint(name, tmp_path):
    setup = tts.build(tcfgs.reduced(tcfgs.get("tinyllama-1.1b")), "cpu",
                      optimizer=name, **OVERRIDES)
    state = tts.init_state(setup)
    step = tts.make_step(setup)
    for b in _batches()[:2]:
        state, _ = step(state, b, LR)
    before = tts.state_digest(state)
    mgr = tman.CheckpointManager(str(tmp_path), setup)
    mgr.save(2, state, cursor=2)
    restored, cursor = mgr.restore(2)
    assert cursor == 2 and tts.state_digest(restored) == before

    jsetup = jts.build(jcfgs.reduced(jcfgs.get("tinyllama-1.1b")),
                       make_local_mesh(), optimizer=name, **OVERRIDES)
    jstate, jcursor = jckpt.restore(str(tmp_path), 2, jabstract(jsetup))
    assert jcursor == 2 and int(jstate["step"]) == 2
    got = convert.flatten(jax.device_get(jstate["opt"]))
    want = convert.flatten(tman.to_tree(setup, restored)["opt"])
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
