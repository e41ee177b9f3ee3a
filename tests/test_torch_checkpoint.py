"""Checkpoints: the port's format, resume, preemption and elastic restore.

* The format: ``tests/test_data_checkpoint.py``'s cases on the port (round
  trip of a tree with a bf16 leaf, an incomplete directory ignored, the
  shape-mismatch policy) and bf16 stored as raw bytes.
* Across packages, both ways, on one rank/device with the reduced
  ``tinyllama-1.1b`` (vocab 64) and ``ef:randomk`` over the size-1 data
  axis, replicated and ZeRO-1, as ``tests/test_adaptive.py``'s
  ``test_ef_state_checkpoint_round_trip``: a JAX checkpoint restores in the
  port equal, bit for bit, to ``convert``'s carry of the same state; a
  port checkpoint restores in JAX's ``ckpt.restore`` against
  ``abstract_state`` bit for bit; a restored port state, in a fresh setup,
  continues bit-identically to the one it was saved from.
* Preemption, in this process: a data iterator that sends SIGTERM to its
  own process while it yields batch k makes the trainer finish step k,
  save it and return; a fresh trainer on the same directory restores it,
  seeks the ``Pipeline(prefetch=0)`` cursor and ends bit-identical to the
  run that was not interrupted.
* Four gloo ranks and two launcher ranks, started together (this file is
  the subprocess script: ``python test_torch_checkpoint.py ranks DIR RANK
  PORT PORT2`` and ``... launcher DIR RANK PORT PORT2``):
  - ZeRO-1 PowerSGD (arch defaults, 5 buckets): 3 uninterrupted steps (A);
    then a trainer whose rank 0 alone gets SIGTERM at the second batch
    (every rank must save step 2 and stop), and a fresh trainer that
    resumes to step 3 (C).  C's step-3 loss and final state equal A's bit
    for bit on every rank.
  - Ranks 0 and 1 then restore step 2 as a world of two: parameters bit
    for bit, ``step``, ``t`` and cursor carried, ``agg`` rebuilt (PowerSGD
    ``q`` not zero), the fp32 master equal to the restored parameters,
    ``m`` and ``v`` zero, and a finite next loss within 0.05 of the
    four-rank step 3's (the JAX package leaves the master at zero here).
  - ``launch.train --adaptive --ckpt-dir D --ckpt-every 1`` on two ranks,
    then again with one more step: the controller's line, checkpoints 1
    and 2, and a resume that runs step 3 only.
  - The JAX package on 4 fake devices (``... jax DIR``): its elastic
    restore onto 2 devices through its ``CheckpointManager`` (see
    ``test_reference_elastic_restore_zeroes_the_master``).
* Two limits of the reference that the port does not copy: the zero
  ZeRO-1 master after JAX's elastic restore, and JAX's manager resetting
  a keyed compressor state (``ef:randomk``) at an equal world size.
"""
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
LAUNCHER_RANKS = 2
TIMEOUT_S = 240
SEQ = 16
GLOBAL_BATCH = 8


# ------------------------------------------------------------- the format
@pytest.fixture(scope="module")
def world():
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{mesh_mod.free_port()}",
        rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _like(tree):
    from repro_torch.checkpoint import checkpoint as ckpt
    return ckpt.rebuild(tree, iter(
        ckpt.Leaf(tuple(x.shape), ckpt.dtype_name(x.dtype))
        for _, x in ckpt.items(tree)))


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    state = {"step": np.int32(7),
             "params": {"w": torch.arange(6.0).reshape(2, 3),
                        "emb": torch.ones((4, 2), dtype=torch.bfloat16)},
             "opt": (torch.zeros((3,)),)}
    d = str(tmp_path)
    for s in (1, 2, 3):
        ckpt.save(d, s, state, cursor=s * 10)
    assert ckpt.list_steps(d) == [1, 2, 3]
    restored, cursor = ckpt.restore(d, 3, _like(state))
    assert cursor == 30
    for (pa, a), (pb, b) in zip(ckpt.items(state), ckpt.items(restored)):
        assert pa == pb
        a = torch.as_tensor(a)
        assert a.dtype == b.dtype and torch.equal(a, b), pa


def test_checkpoint_incomplete_dir_ignored(tmp_path):
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    ckpt.save(str(tmp_path), 1, {"w": torch.ones((2,))})
    os.makedirs(tmp_path / "step_000000002")     # a writer that died
    assert ckpt.list_steps(str(tmp_path)) == [1]


def test_checkpoint_shape_mismatch_policy(tmp_path):
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    ckpt.save(str(tmp_path), 1, {"dev_state": torch.zeros((8, 3)),
                                 "shard": ckpt.PerRank(torch.ones(5))})
    like = {"dev_state": ckpt.Leaf((4, 3), "float32"),
            "shard": ckpt.Leaf((1, 5), "float32", per_rank=True)}
    with pytest.raises(ValueError, match="reset_device_state"):
        ckpt.restore(str(tmp_path), 1, like)
    restored, _ = ckpt.restore(str(tmp_path), 1, like,
                               reset_device_state=True)
    assert restored["dev_state"].shape == (4, 3)
    assert not restored["dev_state"].any()
    assert torch.equal(restored["shard"], torch.ones(5))   # this rank's row
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 1, {"dev_state": like["dev_state"]})


def test_bf16_is_stored_raw_and_jax_reads_it(tmp_path):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.checkpoint import checkpoint as jckpt
    from repro_torch.checkpoint import checkpoint as ckpt
    t = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    t[0, 0] = float("nan")
    ckpt.save(str(tmp_path), 4, {"p": t})
    (entry,) = ckpt.read_meta(str(tmp_path), 4)["index"]
    assert entry == {"file": "leaf_00000.npy", "shape": [3, 5],
                     "dtype": "bfloat16", "raw": True}
    raw = np.load(tmp_path / "step_000000004" / entry["file"])
    assert raw.dtype == np.uint8 and raw.shape == (30,)
    got, _ = jckpt.restore(str(tmp_path), 4,
                           {"p": jax.ShapeDtypeStruct((3, 5), jnp.bfloat16)})
    np.testing.assert_array_equal(
        np.asarray(got["p"]).view(np.uint16),
        t.view(torch.int16).numpy().view(np.uint16))


# ------------------------------------------------------ across packages
def _ef_setups(zero1):
    """(JAX setup, port setup): reduced tinyllama, vocab 64, 1 MB buckets,
    ``ef:randomk`` (5%) over the size-1 data axis."""
    import jax  # noqa: F401

    from repro.configs import base as jcfgs
    from repro.launch.mesh import make_local_mesh
    from repro.train import train_step as jts
    from repro_torch.configs import base as tcfgs
    from repro_torch.train import train_step as tts

    def cfg(base):
        c = base.reduced(base.get("tinyllama-1.1b"))
        plan = dataclasses.replace(c.plan, bucket_mb=1, zero1=zero1)
        return dataclasses.replace(c, vocab=64, plan=plan)
    agg = dict(compressor="ef:randomk", compress_axes=("data",),
               raw_axes=(), compressor_kwargs=dict(frac=0.05))
    js = jts.build(cfg(jcfgs), make_local_mesh())
    js.agg_cfg = dataclasses.replace(js.agg_cfg, **agg)
    js.state_specs = jts._state_specs(js)
    ts = tts.build(cfg(tcfgs), "cpu")
    ts.agg_cfg = dataclasses.replace(ts.agg_cfg, **agg)
    return js, ts


def _batch(step):
    from repro.data.synthetic import DataConfig, batch_at
    return batch_at(DataConfig(vocab=64, seq_len=32, global_batch=4), step)


def _np(x):
    import jax
    import jax.numpy as jnp
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        x = jax.random.key_data(x)
    x = np.asarray(jax.device_get(x))
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _port_np(x):
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    if isinstance(x, ckpt.PerRank):
        v = x.value.unsqueeze(0)
        return v.numpy().astype(np.uint32) if x.prng else _port_np(v)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy().view(np.uint16) \
            if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _carry(js_state, ts, zero1):
    """``convert``'s carry of a JAX state into ``ts``'s live format."""
    import jax

    from repro_torch import convert
    from repro_torch.checkpoint.manager import _unnest
    st = jax.device_get(js_state)
    names = [n for n, _ in ts.model.named_parameters()]
    params = [convert.to_tensor(a)
              for a in convert.flatten(st["params"]).values()]
    if zero1:
        opt = convert.opt_state(st["opt"], 0)
    else:
        opt = {"t": int(st["opt"]["t"]),
               **{k: [convert.to_tensor(a) for a in
                      _unnest(names, st["opt"][k])] for k in ("m", "v")}}
    agg = [jax.tree.map(_np, s) for s in js_state["agg"]]
    return {"step": int(st["step"]), "params": params, "opt": opt,
            "agg": convert.agg_states(ts.agg_cfg.build(), agg, index=0)}


@pytest.mark.parametrize("zero1", [False, True], ids=["replicated", "zero1"])
def test_checkpoints_cross_packages(zero1, tmp_path, world):
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import checkpoint as jckpt
    from repro.checkpoint.manager import abstract_state as jabstract
    from repro.train import train_step as jts
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint import manager as tman
    from repro_torch.train import train_step as tts

    js, ts = _ef_setups(zero1)
    jstate = jts.init_state(js, jax.random.key(0))
    jstate, _ = jts.make_step(js)(_batch(0))(jstate, _batch(0),
                                             jnp.float32(1e-3))
    assert all(np.abs(_np(s.residual)).sum() > 0 for s in jstate["agg"])

    # JAX -> port: equal to convert's carry of the same state
    jdir = str(tmp_path / "jax")
    jckpt.save(jdir, 1, jstate, cursor=1)
    restored, cursor = tman.CheckpointManager(jdir, ts).restore(1)
    carry = _carry(jstate, ts, zero1)
    assert cursor == 1
    assert tts.state_digest(restored) == tts.state_digest(carry)

    # port -> JAX, bit for bit against abstract_state
    state = tts.init_state(ts)
    step = tts.make_step(ts)
    state, _ = step(state, _batch(0), 1e-3)
    pdir = str(tmp_path / "port")
    tman.CheckpointManager(pdir, ts).save(1, state, cursor=1)
    got, jcursor = jckpt.restore(pdir, 1, jabstract(js))
    assert jcursor == 1
    want = [_port_np(x) for _, x in ckpt.items(tman.to_tree(ts, state))]
    have = [_np(x) for x in jax.tree.leaves(got)]
    assert len(want) == len(have)
    for w, h in zip(want, have):
        assert w.shape == h.shape
        np.testing.assert_array_equal(w.astype(h.dtype), h)

    # the restored port state, in a fresh setup, continues bit-identically
    _, fresh = _ef_setups(zero1)
    back, _ = tman.CheckpointManager(pdir, fresh).restore(1)
    assert tts.state_digest(back) == tts.state_digest(state)
    s_a, m_a = step(state, _batch(1), 1e-3)
    s_b, m_b = tts.make_step(fresh)(back, _batch(1), 1e-3)
    assert m_a["loss"].item() == m_b["loss"].item()
    assert tts.state_digest(s_a) == tts.state_digest(s_b)


# ------------------------------------------------------------- preemption
class KillAt:
    """A ``Pipeline`` that sends SIGTERM to this process while it yields
    its ``at``-th batch (from 1), when ``armed``."""

    def __init__(self, pipeline, at, armed=True):
        self.p, self.at, self.armed = pipeline, at, armed
        self.served = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.armed and self.served + 1 == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        self.served += 1
        return next(self.p)

    def cursor(self):
        return self.p.cursor()

    def seek(self, step):
        self.p.seek(step)


def _trainer(setup, vocab, steps, ckpt_dir=None, kill_at=None, rank=0,
             world=1, **kw):
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    data = Pipeline(DataConfig(vocab=vocab, seq_len=SEQ,
                               global_batch=GLOBAL_BATCH),
                    host=rank, num_hosts=world, prefetch=0)
    data = KillAt(data, kill_at, armed=kill_at is not None)
    cfg = TrainerConfig(total_steps=steps, log_every=0, ckpt_dir=ckpt_dir,
                        schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=1,
                                                total_steps=steps), **kw)
    return Trainer(setup, cfg, data)


def test_sigterm_saves_the_step_and_resume_is_exact(tmp_path, world):
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import base as tcfgs
    from repro_torch.train import train_step as tts

    cfg = tcfgs.reduced(tcfgs.get("tinyllama-1.1b"), vocab=64)

    def setup():
        s = tts.build(cfg, "cpu", compression="powersgd", bucket_mb=0.125)
        s.agg_cfg = dataclasses.replace(s.agg_cfg, compress_axes=("data",),
                                        raw_axes=())
        return s
    a = _trainer(setup(), 64, 4)
    a.run()
    d = str(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    b = _trainer(setup(), 64, 4, ckpt_dir=d, kill_at=3, ckpt_every=1,
                 keep_ckpts=1)
    state = b.run()
    assert b.stop_requested and state["step"] == 3
    assert signal.getsignal(signal.SIGTERM) is before
    assert ckpt.list_steps(d) == [3]                   # rotated to one
    assert ckpt.read_meta(d, 3)["cursor"] == 3
    c = _trainer(setup(), 64, 4, ckpt_dir=d)
    c.run()
    assert [r["step"] for r in c.history] == [4]
    assert c.history[0]["loss"] == a.history[3]["loss"]
    assert tts.state_digest(c.state) == tts.state_digest(a.state)
    assert ckpt.list_steps(d) == [3, 4]


# --------------------------------------------------- four gloo ranks
def _ranks_cfg():
    from repro_torch.configs import base as tcfgs
    return tcfgs.reduced(tcfgs.get("tinyllama-1.1b"), vocab=64)


def _rank_setup():
    from repro_torch.train import train_step as tts
    return tts.build(_ranks_cfg(), "cpu", compression="powersgd",
                     bucket_mb=0.125)


def _run_ranks(d, rank, port, port2):
    """Runs A, B (SIGTERM on rank 0 at the second batch) and C on four
    ranks, then the elastic restore on ranks 0 and 1; writes
    ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.train import train_step as tts
    out = {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        vocab = _ranks_cfg().vocab
        a = _trainer(_rank_setup(), vocab, 3, rank=rank, world=RANKS)
        a.run()
        ck = os.path.join(d, "ckpt")
        b = _trainer(_rank_setup(), vocab, 3, ckpt_dir=ck,
                     kill_at=2 if rank == 0 else None, rank=rank,
                     world=RANKS)
        b.run()
        out["b_steps"] = [r["step"] for r in b.history]
        out["b_saved"] = ckpt.list_steps(ck)
        c = _trainer(_rank_setup(), vocab, 3, ckpt_dir=ck, rank=rank,
                     world=RANKS)
        c.run()
        out["n_buckets"] = c.setup.layout.n_buckets
        out["a_loss"] = [r["loss"] for r in a.history]
        out["c_steps"] = [r["step"] for r in c.history]
        out["c_loss"] = [r["loss"] for r in c.history]
        out["same_state"] = (tts.state_digest(a.state)
                             == tts.state_digest(c.state))
        saved = CheckpointManager(ck, _rank_setup()).restore(2)[0]
        out["params_at_2"] = tts.state_digest(saved["params"])
    finally:
        dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port2}",
                                rank=rank, world_size=2)
        try:
            setup = _rank_setup()
            state, cursor = CheckpointManager(ck, setup).restore(2)
            own = tts._zero1_own_slice(setup, setup.layout,
                                       tts._zero1_plan(setup),
                                       state["params"])
            shard = state["opt"]["shard"]
            out["elastic"] = dict(
                step=state["step"], t=state["opt"]["t"], cursor=cursor,
                params=tts.state_digest(state["params"]),
                q_abs=[float(st.q.abs().sum()) for st in state["agg"]],
                master_is_params=bool(torch.equal(shard["master"], own)),
                master_abs=float(shard["master"].abs().sum()),
                mv_zero=not (shard["m"].any() or shard["v"].any()))
            data = Pipeline(DataConfig(vocab=setup.arch.vocab, seq_len=SEQ,
                                       global_batch=GLOBAL_BATCH),
                            host=rank, num_hosts=2, prefetch=0)
            data.seek(cursor)
            _, m = tts.make_step(setup)(state, next(data), 1e-3)
            out["elastic"]["loss"] = m["loss"].item()
        finally:
            dist.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _run_jax_elastic(d):
    """The JAX package's elastic restore (4 fake devices, then 2 of them),
    ZeRO-1 as the arch configures it, vocab 64, 0.25 MB buckets: one step,
    a save, a restore through its ``CheckpointManager`` on 2 devices and
    two more steps, beside the run that was not interrupted; writes
    ``jax.json``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.configs import base as jcfgs
    from repro.data.synthetic import DataConfig, batch_at
    from repro.train import train_step as jts
    arch = jcfgs.reduced(jcfgs.get("tinyllama-1.1b"), vocab=64)
    dcfg = DataConfig(vocab=64, seq_len=SEQ, global_batch=GLOBAL_BATCH)
    lr = jnp.float32(1e-3)

    def setup(n):
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(n, 1),
                    ("data", "model"))
        return jts.build(arch, mesh, bucket_mb=0.25)

    def mean_abs(params):
        leaves = [np.abs(np.asarray(x, np.float32))
                  for x in jax.tree.leaves(jax.device_get(params))]
        return float(np.concatenate([x.ravel() for x in leaves]).mean())
    s4 = setup(4)
    st = jts.init_state(s4, jax.random.key(0))
    step4 = jts.make_step(s4)(batch_at(dcfg, 0))
    st, _ = step4(st, batch_at(dcfg, 0), lr)
    ck = os.path.join(d, "jax_ckpt")
    JManager(ck, s4).save(1, st)
    out = {}
    for label, (s, restored) in {
            "uninterrupted": (s4, st),
            "elastic": (setup(2), None)}.items():
        if restored is None:
            restored, _ = JManager(ck, s).restore(1)
            out["master_shape"] = list(restored["opt"]["shard"]["master"]
                                       .shape)
            out["master_sum"] = float(jnp.sum(
                restored["opt"]["shard"]["master"]))
        step = jts.make_step(s)(batch_at(dcfg, 1))
        restored, _ = step(restored, batch_at(dcfg, 1), lr)
        out[label] = {"mean_abs_param": mean_abs(restored["params"])}
        _, m = step(restored, batch_at(dcfg, 2), lr)   # donates restored
        out[label]["next_loss"] = float(m["loss"])
    with open(os.path.join(d, "jax.json"), "w") as f:
        json.dump(out, f)


def _run_launcher(d, rank, port, port2):
    """``launch.train --adaptive --ckpt-dir`` on two ranks, twice."""
    from repro_torch.launch import train as launch
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(LAUNCHER_RANKS),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(LAUNCHER_RANKS),
                      MASTER_ADDR="127.0.0.1")
    common = ["--device", "cpu", "--adaptive", "--batch", "4", "--seq",
              str(SEQ), "--ckpt-dir", os.path.join(d, "launch"),
              "--ckpt-every", "1", "--log-every", "1"]
    for steps, p in (("2", port), ("3", port2)):
        os.environ["MASTER_PORT"] = p
        print(f"=== run {steps}", flush=True)
        launch.main(common + ["--steps", steps])


def _env():
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("ckpt_ranks"))
    me = os.path.abspath(__file__)
    ports = [str(free_port()) for _ in range(4)]
    procs = [subprocess.Popen([sys.executable, me, "ranks", d, str(r)]
                              + ports[:2], env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    procs += [subprocess.Popen([sys.executable, me, "launcher", d, str(r)]
                               + ports[2:], env=_env(),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(LAUNCHER_RANKS)]
    xla = os.environ.get("XLA_FLAGS", "") \
        + f" --xla_force_host_platform_device_count={RANKS}"
    procs.append(subprocess.Popen(
        [sys.executable, me, "jax", d], env=dict(
            _env(), XLA_FLAGS=xla, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
    return d, recs, logs[RANKS]


def test_sigterm_on_one_rank_resumes_bit_exact_on_four(ranks):
    _, recs, _ = ranks
    for r, rec in enumerate(recs):
        assert rec["n_buckets"] == 5
        assert rec["b_steps"] == [1, 2] and rec["b_saved"] == [2], r
        assert rec["c_steps"] == [3], r
        assert rec["c_loss"][0] == rec["a_loss"][2], r
        assert rec["same_state"], r
    assert len({rec["params_at_2"] for rec in recs}) == 1


def test_elastic_restore_four_to_two_refills_the_master(ranks):
    _, recs, _ = ranks
    for r in range(2):
        e = recs[r]["elastic"]
        assert (e["step"], e["t"], e["cursor"]) == (2, 2, 2)
        assert e["params"] == recs[r]["params_at_2"]
        assert all(q > 0 for q in e["q_abs"]) and len(e["q_abs"]) == 5
        assert e["master_is_params"] and e["master_abs"] > 0
        assert e["mv_zero"]
        assert np.isfinite(e["loss"])
        assert abs(e["loss"] - recs[r]["c_loss"][0]) <= 0.05


def test_reference_elastic_restore_zeroes_the_master(ranks):
    """A limit of the reference that the port does not copy: JAX's elastic
    restore gives ZeRO-1 a zero fp32 master, so the next step writes the
    update of zero into the parameters (the port refills the master:
    ``test_elastic_restore_four_to_two_refills_the_master``)."""
    d, recs, _ = ranks
    with open(os.path.join(d, "jax.json")) as f:
        j = json.load(f)
    assert j["master_shape"][0] == 2 and j["master_sum"] == 0.0
    assert j["elastic"]["mean_abs_param"] < \
        0.05 * j["uninterrupted"]["mean_abs_param"]
    assert abs(j["elastic"]["next_loss"] - np.log(64)) < 1e-3
    assert recs[0]["elastic"]["master_abs"] > 0


def test_reference_manager_heals_a_keyed_state_at_an_equal_world(
        tmp_path, world):
    """Another reference limit the port does not copy: JAX's manager
    compares a key's saved words ``(n_dev, 2)`` with its shape ``(n_dev,)``
    and so rebuilds ``agg`` on every restore of a keyed compressor state,
    error-feedback residual included; the port's restore is exact."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import train_step as jts
    from repro_torch.checkpoint import manager as tman
    from repro_torch.train import train_step as tts
    js, ts = _ef_setups(False)
    st = jts.init_state(js, jax.random.key(0))
    st, _ = jts.make_step(js)(_batch(0))(st, _batch(0), jnp.float32(1e-3))
    JManager(str(tmp_path / "j"), js).save(1, st)
    back, _ = JManager(str(tmp_path / "j"), js).restore(1)
    saved = float(np.abs(_np(st["agg"][0].residual)).sum())
    assert saved > 0 and float(np.abs(_np(back["agg"][0].residual)).sum()) \
        == 0.0
    state = tts.init_state(ts)
    state, _ = tts.make_step(ts)(state, _batch(0), 1e-3)
    mgr = tman.CheckpointManager(str(tmp_path / "t"), ts)
    mgr.save(1, state)
    assert state["agg"][0].residual.abs().sum() > 0
    assert tts.state_digest(mgr.restore(1)[0]) == tts.state_digest(state)


def test_launcher_adaptive_and_checkpoints_on_two_ranks(ranks):
    from repro_torch.adaptive import controller as actl
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import base as tcfgs
    d, _, log = ranks
    arch = tcfgs.reduced(tcfgs.get("tinyllama-1.1b"))
    _, dec = actl.resolve_plan(arch.plan, arch, LAUNCHER_RANKS, batch=4,
                               seq=SEQ)
    first, second = log.split("=== run 3")
    assert f"[train] adaptive: scheme={dec.scheme} comm={dec.comm}" in first
    assert dec.scheme == "powersgd"
    assert "overlap=True" in first and "agg=powersgd@('data',)" in first
    assert re.findall(r"^step +(\d+)", first, re.M) == ["1", "2"]
    assert re.findall(r"^step +(\d+)", second, re.M) == ["3"]
    assert "[train] done at step 3" in second
    assert ckpt.list_steps(os.path.join(d, "launch")) == [1, 2, 3]


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax_elastic(sys.argv[2])
    else:
        {"ranks": _run_ranks, "launcher": _run_launcher}[sys.argv[1]](
            sys.argv[2], int(sys.argv[3]), *sys.argv[4:])
