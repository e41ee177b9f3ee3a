"""Every compressor's aggregation over 4 ranks: the port on 4 gloo
processes against the JAX package on 4 fake CPU devices (a subprocess that
forces the device count, as ``tests/dist/`` does).  Every rank gets its own
gradient bucket and error-feedback residual; the PowerSGD warm start and
the stochastic schemes' keys are shared.  The same numpy inputs go to both.

The draws are JAX's: the test process computes, from each scheme's key,
every rank's QSGD and TernGrad uniforms (``fold_in(sub, rank)``, as the
JAX compressors draw them) and RandomK's shared indices, and each gloo
rank puts its own in place of the port's draw function.  The port's keys
are its own stream: checked to advance by ``split_key``, the same on every
rank.

Tolerance: ``rtol=atol=1e-5`` on the aggregated bucket and on each rank's
new state (fp32; gloo's and XLA's sums run in different orders).  QSGD's
norm is a sum of n squares in another order on each side and may differ in
its last bit: a level may then move by one step (norm / levels) on at most
1e-4 of the elements (and one).

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
COMPRESSORS = ("powersgd", "signsgd", "qsgd", "terngrad", "mstopk",
               "randomk", "ef:signsgd")
TIMEOUT_S = 240


def _fname(name):
    return name.replace(":", "_")


def _make_inputs(d):
    """in.npz: buckets and, per compressor, every state field stacked over
    the ranks (``<name>/<dotted field>``; keys as raw words); draws.npz:
    JAX's draws per compressor."""
    import jax
    import jax.numpy as jnp

    from repro.core.compression import base
    rng = np.random.default_rng(4)
    arrays = {"bucket": rng.standard_normal((RANKS, N)).astype(np.float32)}
    draws = {}
    for i, name in enumerate(COMPRESSORS):
        comp = base.make(name)
        state = comp.init_state(N, jax.random.key(100 + i))
        for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
            field = ".".join(p.name for p in path)
            if jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
                a = np.asarray(jax.random.key_data(leaf))
            elif leaf.shape == (N,):              # a live residual per rank
                a = (0.1 * rng.standard_normal((RANKS, N))).astype(np.float32)
                arrays[f"{name}/{field}"] = a
                continue
            else:
                a = np.asarray(leaf)
            arrays[f"{name}/{field}"] = np.broadcast_to(
                a, (RANKS,) + a.shape).copy()
        st = state.inner if name.startswith("ef:") else state
        if name in ("qsgd", "terngrad"):
            _, sub = jax.random.split(st.key)
            draws[name] = np.stack([np.asarray(jax.random.uniform(
                jax.random.fold_in(sub, r), (N,), jnp.float32))
                for r in range(RANKS)])
        elif name == "randomk":
            _, sub = jax.random.split(st.key)
            draws[name] = np.asarray(
                jax.random.permutation(sub, N)[:comp.k_for(N)])
    np.savez(os.path.join(d, "in.npz"), **arrays)
    np.savez(os.path.join(d, "draws.npz"), **draws)


def _fields(inp, name):
    """The stacked state fields of ``name`` in in.npz."""
    return {k.split("/", 1)[1]: inp[k] for k in inp.files
            if k.startswith(name + "/")}


def _nest(fields):
    """{dotted path: value} -> nested dicts."""
    out = {}
    for path, v in fields.items():
        *head, last = path.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _run_jax(d):
    """All compressors on a 4-device data mesh; writes jax_<name>.npz."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core.compression import base
    from repro.parallel.compat import make_mesh, shard_map
    assert len(jax.devices()) == RANKS
    inp = np.load(os.path.join(d, "in.npz"))
    mesh = make_mesh((RANKS,), ("data",))
    for name in COMPRESSORS:
        comp = base.make(name)
        template = comp.init_state(N, jax.random.key(0))
        paths, treedef = jax.tree_util.tree_flatten_with_path(template)
        names = [".".join(p.name for p in path) for path, _ in paths]
        is_key = [jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key)
                  for _, leaf in paths]
        fields = _fields(inp, name)

        def run(b, *leaves, comp=comp, treedef=treedef, is_key=is_key):
            st = jax.tree_util.tree_unflatten(treedef, [
                jax.random.wrap_key_data(x[0]) if k else x[0]
                for x, k in zip(leaves, is_key)])
            out, new = comp.aggregate(b[0], st, ("data",))
            new = [jax.random.key_data(x) if k else x for x, k in
                   zip(jax.tree_util.tree_leaves(new), is_key)]
            return out[None], [x[None] for x in new]

        f = shard_map(run, mesh, in_specs=(P("data"),) * (1 + len(names)),
                      out_specs=(P("data"), P("data")))
        out, new = f(inp["bucket"], *[fields[n] for n in names])
        np.savez(os.path.join(d, f"jax_{_fname(name)}.npz"),
                 out=np.asarray(out),
                 **{n: np.asarray(v) for n, v in zip(names, new)})


def _flat(state, prefix=""):
    out = {}
    for name, v in zip(state._fields, state):
        if isinstance(v, tuple):
            out.update(_flat(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = v.numpy()
    return out


def _run_torch(d, rank, port):
    """One gloo rank; writes torch_<name>_<rank>.npz."""
    import torch
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.core.compression import base
    from repro_torch.core.compression import qsgd, randomk, terngrad
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        inp = np.load(os.path.join(d, "in.npz"))
        draws = np.load(os.path.join(d, "draws.npz"))

        def uniform_of(name):
            def uniform(key, r, n, device):
                assert r == rank and n == N
                return torch.from_numpy(draws[name][rank].copy())
            return uniform
        qsgd.uniform = uniform_of("qsgd")
        terngrad.uniform = uniform_of("terngrad")
        randomk.indices = lambda key, n, k, device: torch.from_numpy(
            draws["randomk"].astype(np.int64))
        for name in COMPRESSORS:
            comp = base.make(name)
            (st,) = convert.agg_states(comp, [_nest(_fields(inp, name))],
                                       index=rank)
            out, new = comp.aggregate(
                torch.from_numpy(inp["bucket"][rank].copy()), st, ("data",))
            np.savez(os.path.join(d, f"torch_{_fname(name)}_{rank}.npz"),
                     out=out.numpy(), **_flat(new))
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
    _make_inputs(d)
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
    import torch

    from repro_torch.core.compression.base import split_key
    jax_out = np.load(os.path.join(results, f"jax_{_fname(name)}.npz"))
    start = _fields(np.load(os.path.join(results, "in.npz")), name)
    bucket = np.load(os.path.join(results, "in.npz"))["bucket"]
    for rank in range(RANKS):
        got = np.load(os.path.join(results,
                                   f"torch_{_fname(name)}_{rank}.npz"))
        assert set(got.files) == set(jax_out.files)
        # QSGD's level step: this rank's compensated gradient's norm / 127
        g = bucket[rank] + sum(v[rank] for v in start.values()
                               if v.shape == (RANKS, N))
        step = np.linalg.norm(g) / 127
        for k in got.files:
            what = f"{k} rank {rank}"
            if k.endswith("key"):           # the port's own stream
                np.testing.assert_array_equal(got[k], split_key(
                    torch.from_numpy(start[k][rank].astype(np.int64)))[0])
                continue
            want = jax_out[k][rank]
            if name == "qsgd":
                step_k = step if k != "out" else max(
                    np.linalg.norm(bucket[r]) for r in range(RANKS)) / 127
                bad = ~np.isclose(got[k], want, rtol=1e-5, atol=1e-5)
                assert bad.sum() <= max(1, 1e-4 * want.size), (what,
                                                               bad.sum())
                np.testing.assert_array_less(
                    np.abs(got[k] - want)[bad], step_k * 1.001 + 1e-5,
                    err_msg=what)
            else:
                np.testing.assert_allclose(got[k], want, rtol=1e-5,
                                           atol=1e-5, err_msg=what)
    # the aggregate is the same on every rank
    outs = [np.load(os.path.join(results,
                                 f"torch_{_fname(name)}_{r}.npz"))["out"]
            for r in range(RANKS)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    if "signsgd" in name:
        np.testing.assert_array_equal(np.sign(outs[0]),
                                      np.sign(jax_out["out"][0]))


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _run_jax(sys.argv[2])
    else:
        _run_torch(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
