"""Two full steps of the slice — the classic DDP step with ``zero1=False``,
AdamW and PowerSGD, SignSGD or QSGD — on one rank, against the JAX
package's ``make_step`` from carried-over parameters and compressor state.
Both builds drop the size-1 ``data`` axis; both are pointed back at it (as
``tests/test_adaptive.py`` does) so every bucket runs through the
compressor.  QSGD gets JAX's draws: the test computes, from each bucket's
carried-over key, the uniform that the JAX step draws for it in each step,
and hands them to the port's ``qsgd.uniform`` in the order the port asks
for them (bucket by bucket, step by step).  Also: what ``build`` refuses,
and that the entry points refuse to run without a GPU unless asked for the
CPU.  ZeRO-1 (the arch's default) and accumulation are held to the JAX
package in ``tests/test_torch_zero1.py``.

Tolerances (bf16 compute on both sides, rounded at different places):
loss ``rtol=1e-3``; grad norm ``rtol=1e-2``; parameters ``atol`` of
``2 * lr`` per step plus ``1e-4``, because AdamW moves every element by
about ``lr`` in the direction of its gradient's sign, which bf16 rounding
can flip for near-zero entries — but at most 2% of the elements of a leaf
may differ by more than ``lr / 2``, and the median difference must stay
below ``lr / 50``.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jcfgs
from repro.data.synthetic import DataConfig, batch_at
from repro.launch.mesh import make_local_mesh
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs import base as tcfgs
from repro_torch.core.compression import qsgd as tqsgd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import train_step as tts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 2
OVERRIDES = dict(zero1=False, bucket_mb=0.5)       # 4 buckets


@pytest.fixture(scope="module", autouse=True)
def world():
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{mesh_mod.free_port()}",
        rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _batches():
    cfg = DataConfig(vocab=512, seq_len=32, global_batch=4)
    return [batch_at(cfg, s) for s in range(STEPS)]


def _run_jax(comp):
    cfg = jcfgs.reduced(jcfgs.get("tinyllama-1.1b"))
    setup = jts.build(cfg, make_local_mesh(), compression=comp, **OVERRIDES)
    setup.agg_cfg = dataclasses.replace(
        setup.agg_cfg, compress_axes=("data",), raw_axes=())
    setup.state_specs = jts._state_specs(setup)
    state = jts.init_state(setup, jax.random.key(0))
    start = jax.tree.map(
        lambda x: np.asarray(jax.random.key_data(x)
                             if jnp.issubdtype(x.dtype, jax.dtypes.prng_key)
                             else x),
        jax.device_get({"params": state["params"], "agg": state["agg"]}))
    batches = _batches()
    step = jts.make_step(setup)(batches[0])
    metrics = []
    for b in batches:
        state, m = step(state, b, jnp.float32(LR))
        metrics.append(jax.device_get(m))
    return start, metrics, jax.device_get(state["params"])


def _run_port(comp, start):
    cfg = tcfgs.reduced(tcfgs.get("tinyllama-1.1b"))
    setup = tts.build(cfg, "cpu", compression=comp, **OVERRIDES)
    assert setup.agg_cfg.compress_axes == ()          # the size-1 axis went
    setup.agg_cfg = dataclasses.replace(
        setup.agg_cfg, compress_axes=("data",), raw_axes=())
    state = tts.init_state(setup)
    convert.load_params(setup.model, start["params"])
    state["agg"] = convert.agg_states(setup.agg_cfg.build(), start["agg"],
                                      index=0)
    assert len(state["agg"]) == setup.layout.n_buckets == 4
    step = tts.make_step(setup)
    metrics = []
    for b in _batches():
        state, m = step(state, b, LR)
        metrics.append({k: v.item() for k, v in m.items()})
    return metrics, setup.model


def _qsgd_draws(agg):
    """JAX's uniforms for every QSGD encode of the run, in the port's call
    order: the JAX step splits each bucket's key, folds in the rank (0)
    and advances the key by the split's first half."""
    keys = [jax.random.wrap_key_data(st.key[0]) for st in agg]
    draws = []
    for _ in range(STEPS):
        for i, st in enumerate(agg):
            carry, sub = jax.random.split(keys[i])
            draws.append(np.array(jax.random.uniform(
                jax.random.fold_in(sub, 0), st.err.shape[1:], jnp.float32)))
            keys[i] = carry
    return draws


@pytest.mark.parametrize("comp", ["powersgd", "signsgd", "qsgd"])
def test_two_steps_match_jax(comp, monkeypatch):
    start, jmetrics, jparams = _run_jax(comp)
    if comp == "qsgd":
        draws = iter(_qsgd_draws(start["agg"]))

        def uniform(key, rank, n, device):
            u = next(draws)
            assert rank == 0 and u.shape == (n,)
            return torch.from_numpy(u)
        monkeypatch.setattr(tqsgd, "uniform", uniform)
    tmetrics, model = _run_port(comp, start)
    if comp == "qsgd":
        assert next(draws, None) is None        # every draw was used
    for jm, tm in zip(jmetrics, tmetrics):
        assert tm["tokens"] == int(jm["tokens"]) == 128
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-3)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-2)
    flat = convert.flatten(jparams)
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - flat[name])
        assert diff.max() <= 2 * LR * STEPS + 1e-4, (name, diff.max())
        assert (diff > LR / 2).mean() <= 0.02, (name, (diff > LR / 2).mean())
        assert np.median(diff) <= LR / 50, (name, np.median(diff))


# ------------------------------------------------------------ build rules
@pytest.mark.parametrize("overrides,refused", [
    # ported (tests/test_torch_fsdp.py): on one rank, as in the JAX
    # package, the size-1 FSDP axis goes and the step runs unsharded
    (dict(zero1=False, dp_mode="fsdp"), False),
    # the overlapped DDP step is ported (tests/test_torch_overlap.py); an
    # overlapped FSDP step is not, in either package: JAX's ValueError
    (dict(zero1=False, overlap=True, dp_mode="fsdp"), ValueError),
    # resolved before build (adaptive.controller.resolve_plan); build reads
    # the plan's static fields, as the JAX build does
    (dict(zero1=False, adaptive=True), False),
    # ported with the pod axis (tests/test_torch_pod.py): on one rank, as in
    # the JAX package, the size-1 data axis goes and nothing is aggregated
    (dict(zero1=False, comm="hierarchical"), False),
    # ported on the replicated step (tests/test_torch_optimizer.py)
    (dict(zero1=False, optimizer="adafactor"), False),
    (dict(zero1=False, compress_axes="all"), False),
], ids=["fsdp", "overlap", "adaptive", "hierarchical", "adafactor",
        "compress-axes-all"])
def test_build_refuses_what_is_not_ported(overrides, refused):
    cfg = tcfgs.reduced(tcfgs.get("tinyllama-1.1b"))
    if refused:
        with pytest.raises(refused):
            tts.build(cfg, "cpu", **overrides)
        return
    setup = tts.build(cfg, "cpu", **overrides)
    assert setup.dp_axes == ("data",)
    assert (setup.agg_cfg.compress_axes, setup.agg_cfg.raw_axes) == ((), ())
    assert (setup.fsdp_axes, setup.p_fsdp) == ((), 1)


def test_init_state_gives_every_bucket_its_own_key():
    """The stochastic compressors' keys come bucket by bucket from one
    seeded generator: distinct across buckets, repeated for the seed, and
    on the host."""
    setup = tts.build(tcfgs.reduced(tcfgs.get("tinyllama-1.1b")), "cpu",
                      compression="ef:qsgd", **OVERRIDES)
    setup.agg_cfg = dataclasses.replace(
        setup.agg_cfg, compress_axes=("data",), raw_axes=())
    keys = [st.inner.key for st in tts.init_state(setup)["agg"]]
    assert len(keys) == 4 and all(k.device.type == "cpu" for k in keys)
    assert len({tuple(k.tolist()) for k in keys}) == 4
    again = [st.inner.key for st in tts.init_state(setup)["agg"]]
    assert all(torch.equal(a, b) for a, b in zip(keys, again))


# ------------------------------------------------------- no GPU, no run
def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only behaviour does not apply")


def test_build_raises_without_gpu():
    _no_gpu()
    cfg = tcfgs.reduced(tcfgs.get("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.build(cfg, zero1=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.resolve_device("cuda")
    assert mesh_mod.resolve_device("cpu") == torch.device("cpu")


def test_launcher_raises_without_gpu_and_runs_on_cpu():
    _no_gpu()
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    # a second process group would collide with this module's: run the
    # CPU launcher in its own process
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1",
         "--compression", "signsgd"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "agg=signsgd@()" in out.stdout and "done at step 2" in out.stdout


def test_launcher_runs_qsgd_on_four_gloo_ranks():
    """``--compression qsgd`` through the launcher on 4 CPU ranks: the
    ``data`` axis has size 4, so every bucket is quantized and
    all-gathered."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
         "--log-every", "1", "--compression", "qsgd"],
        env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "world=4" in out.stdout and "agg=qsgd@('data',)" in out.stdout
    assert "done at step 2" in out.stdout


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No result without a card, and none from a directory holding only
    the script."""
    _no_gpu()
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
