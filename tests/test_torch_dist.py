"""PowerSGD and SignSGD aggregation over 4 ranks: the port on 4 gloo
processes against the JAX package on 4 fake CPU devices (a subprocess that
forces the device count, as ``tests/dist/`` does).  Every rank gets its own
gradient bucket and error-feedback residual; the PowerSGD warm start is
shared.  The same numpy inputs go to both.

Tolerance: ``rtol=atol=1e-5`` on the aggregated bucket and on each rank's
new state (fp32; gloo's and XLA's sums run in different orders).

This file is also the subprocess script: ``python test_torch_dist.py jax
DIR`` or ``python test_torch_dist.py torch DIR RANK PORT``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
N = 70_000                       # a ragged PowerSGD matrix (183 x 384)
COMPRESSORS = ("powersgd", "signsgd")
TIMEOUT_S = 240


def _make_inputs(path):
    from repro_torch.core.compression.powersgd import matrix_shape
    rng = np.random.default_rng(4)
    _, cols = matrix_shape(N)
    np.savez(path,
             bucket=rng.standard_normal((RANKS, N)).astype(np.float32),
             err=(0.1 * rng.standard_normal((RANKS, N))).astype(np.float32),
             q=rng.standard_normal((cols, 4)).astype(np.float32))


def _run_jax(d):
    """All compressors on a 4-device data mesh; writes jax_<name>.npz."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.core.compression import base
    from repro.parallel.compat import make_mesh, shard_map
    assert len(jax.devices()) == RANKS
    inp = np.load(os.path.join(d, "in.npz"))
    mesh = make_mesh((RANKS,), ("data",))
    for name in COMPRESSORS:
        comp = base.make(name)
        cls = type(comp.init_state(N, jax.random.key(0)))

        def run(b, err, q, comp=comp, cls=cls):
            st = cls(**{"err": err[0], "q": q}) if "q" in cls._fields \
                else cls(err=err[0])
            out, new = comp.aggregate(b[0], st, ("data",))
            return out[None], {k: v[None] for k, v in new._asdict().items()}

        f = shard_map(run, mesh, in_specs=(P("data"), P("data"), P()),
                      out_specs=(P("data"), P("data")))
        out, new = f(inp["bucket"], inp["err"], inp["q"])
        np.savez(os.path.join(d, f"jax_{name}.npz"), out=np.asarray(out),
                 **{k: np.asarray(v) for k, v in new.items()})


def _run_torch(d, rank, port):
    """One gloo rank; writes torch_<name>_<rank>.npz."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.compression import base
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        inp = np.load(os.path.join(d, "in.npz"))
        for name in COMPRESSORS:
            comp = base.make(name)
            cls = type(comp.init_state(N, None, device="meta"))
            fields = {"err": torch.from_numpy(inp["err"][rank].copy()),
                      "q": torch.from_numpy(inp["q"])}
            st = cls(**{k: fields[k] for k in cls._fields})
            out, new = comp.aggregate(
                torch.from_numpy(inp["bucket"][rank].copy()), st, ("data",))
            np.savez(os.path.join(d, f"torch_{name}_{rank}.npz"),
                     out=out.numpy(),
                     **{k: v.numpy() for k, v in new._asdict().items()})
    finally:
        dist.destroy_process_group()


def _env(**extra):
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.mesh import free_port
    d = str(tmp_path_factory.mktemp("dist4"))
    _make_inputs(os.path.join(d, "in.npz"))
    me = os.path.abspath(__file__)
    xla = os.environ.get("XLA_FLAGS", "") \
        + f" --xla_force_host_platform_device_count={RANKS}"
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, me, "jax", d],
                              env=_env(XLA_FLAGS=xla), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, me, "torch", d, str(r), port],
                               env=_env(OMP_NUM_THREADS="1"),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(RANKS)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, f"{p.args[2:]} failed:\n{text[-3000:]}"
    return d


@pytest.mark.parametrize("name", COMPRESSORS)
def test_aggregate_matches_jax_on_four_ranks(results, name):
    jax_out = np.load(os.path.join(results, f"jax_{name}.npz"))
    for rank in range(RANKS):
        got = np.load(os.path.join(results, f"torch_{name}_{rank}.npz"))
        assert set(got.files) == set(jax_out.files)
        for k in got.files:
            np.testing.assert_allclose(got[k], jax_out[k][rank], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} rank {rank}")
    # the aggregate is the same on every rank
    outs = [np.load(os.path.join(results, f"torch_{name}_{r}.npz"))["out"]
            for r in range(RANKS)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    if name == "signsgd":
        np.testing.assert_array_equal(np.sign(outs[0]),
                                      np.sign(jax_out["out"][0]))


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
