"""Every compressor's aggregation on one rank: the port on a one-rank gloo
group against the JAX package on a one-device ``data`` mesh, from the same
bucket and carried-over state; wire bytes; the CommPlan copy; the
compressor registry and the ``ef:`` wrapper.

The stochastic schemes (QSGD, TernGrad, RandomK) get JAX's own draws: the
test computes them from the JAX state's key as the JAX compressor does
(``bernoulli(k, p) == uniform(k) < p``; the permutation for RandomK) and
puts them in place of the port's one draw function.  The port's keys are
its own stream: they are checked to advance by ``split_key``, not against
JAX's.

Tolerances: outputs and new state to ``rtol=1e-5, atol=1e-5`` (fp32 in
both, summed in different orders; the bucket values are of order one);
SignSGD's signs exactly.  QSGD's norm is a sum of n squares, taken in
another order by XLA and by torch, so it may differ in its last bit and
move an element's level by one step: at most 1e-4 of the elements (and
one) may then differ, each by at most one level (norm / levels).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.core.compression import base as jbase
from repro.parallel import commplan as jcp
from repro.parallel.compat import make_mesh, shard_map
from repro_torch import convert
from repro_torch.core.compression import base as tbase
from repro_torch.core.compression import qsgd as tqsgd
from repro_torch.core.compression import randomk as trandomk
from repro_torch.core.compression import terngrad as tterngrad
from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import commplan as tcp

SIZES = [5_000, 70_000]          # ragged matrix shapes (pad 120 and 272)


@pytest.fixture(scope="module", autouse=True)
def world():
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{mesh_mod.free_port()}",
        rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _jax_aggregate(comp, bucket, state):
    mesh = make_mesh((1,), ("data",))
    f = shard_map(lambda b, s: comp.aggregate(b, s, ("data",)), mesh,
                  in_specs=(P(), P()), out_specs=(P(), P()))
    out, new = f(bucket, state)
    return np.asarray(out), jax.device_get(new)


def _inputs(comp_name, n, seed):
    """A bucket, the JAX compressor and its state with a live residual in
    every (n,) fp32 field (``err``, ``residual``)."""
    rng = np.random.default_rng(seed)
    bucket = rng.standard_normal(n).astype(np.float32)
    jcomp = jbase.make(comp_name)
    jstate = jcomp.init_state(n, jax.random.key(seed))

    def live(x):
        if x.shape == (n,) and x.dtype == jnp.float32:
            return jnp.asarray((0.1 * rng.standard_normal(n))
                               .astype(np.float32))
        return x
    return bucket, jcomp, jax.tree.map(live, jstate)


def host(tree):
    """A JAX state on the host, typed keys as their raw words."""
    return jax.tree.map(
        lambda x: np.asarray(jax.random.key_data(x)
                             if jnp.issubdtype(x.dtype, jax.dtypes.prng_key)
                             else x), jax.device_get(tree))


def flat(state, prefix=""):
    """A state (NamedTuples, nested) -> {dotted field path: array}."""
    out = {}
    for name, v in zip(state._fields, state):
        if isinstance(v, tuple):
            out.update(flat(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = np.asarray(v)
    return out


def jax_draws(comp_name, jstate, n, ranks=1):
    """What the JAX compressor draws in one encode: per rank, QSGD's and
    TernGrad's (n,) uniforms; RandomK's shared indices.  ``None`` for the
    deterministic schemes."""
    inner = comp_name.removeprefix("ef:")
    st = jstate.inner if comp_name.startswith("ef:") else jstate
    if inner in ("qsgd", "terngrad"):
        _, sub = jax.random.split(st.key)
        return np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(sub, r), (n,), jnp.float32))
            for r in range(ranks)])
    if inner == "randomk":
        _, sub = jax.random.split(st.key)
        k = jbase.make("randomk").k_for(n)
        return np.asarray(jax.random.permutation(sub, n)[:k])
    return None


def inject(monkeypatch, comp_name, draws, rank=0):
    """Put JAX's draws in place of the port's draw function."""
    inner = comp_name.removeprefix("ef:")
    if inner in ("qsgd", "terngrad"):
        mod = tqsgd if inner == "qsgd" else tterngrad

        def uniform(key, r, n, device):
            assert r == rank and n == draws.shape[1]
            return torch.from_numpy(draws[rank].copy()).to(device)
        monkeypatch.setattr(mod, "uniform", uniform)
    elif inner == "randomk":
        monkeypatch.setattr(
            trandomk, "indices",
            lambda key, n, k, device: torch.from_numpy(
                draws.astype(np.int64)).to(device))


def assert_level_close(got, want, step, what):
    """fp32-close, except that a level may move by one ``step`` on at most
    1e-4 of the elements (and one)."""
    bad = ~np.isclose(got, want, rtol=1e-5, atol=1e-5)
    assert bad.sum() <= max(1, 1e-4 * got.size), (what, int(bad.sum()))
    np.testing.assert_array_less(np.abs(got - want)[bad],
                                 np.max(step) * 1.001 + 1e-5, err_msg=what)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("comp_name", ["powersgd", "signsgd", "qsgd",
                                       "terngrad", "randomk", "mstopk",
                                       "ef:signsgd", "ef:qsgd",
                                       "ef:randomk"])
def test_aggregate_matches_jax_on_one_rank(comp_name, n, monkeypatch):
    bucket, jcomp, jstate = _inputs(comp_name, n, n)
    inject(monkeypatch, comp_name, jax_draws(comp_name, jstate, n))
    jout, jnew = _jax_aggregate(jcomp, bucket, jstate)
    tcomp = tbase.make(comp_name)
    (tstate,) = convert.agg_states(tcomp, [host(jstate)], index=None)
    tout, tnew = tcomp.aggregate(torch.from_numpy(bucket), tstate, ("data",))
    got, want, old = flat(tnew), flat(host(jnew)), flat(tstate)
    assert set(got) == set(want)
    # QSGD's level step: the norm of the error-compensated gradient / 127
    g = bucket + sum(v for v in old.values() if v.shape == (n,))
    step = np.linalg.norm(g) / 127
    close = (lambda a, b, what: assert_level_close(a, b, step, what)) \
        if "qsgd" in comp_name else \
        (lambda a, b, what: np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-5, err_msg=what))
    for name in got:
        if name.endswith("key"):        # the port's own stream
            np.testing.assert_array_equal(
                got[name], tbase.split_key(torch.from_numpy(old[name]))[0])
        else:
            close(got[name], want[name], name)
    close(tout.numpy(), jout, "out")
    if "signsgd" in comp_name:
        np.testing.assert_array_equal(np.sign(tout.numpy()), np.sign(jout))


@pytest.mark.parametrize("comp_name,n,want", [
    ("powersgd", 6_553_600, (40_960, 40_960)),   # full tinyllama bucket
    ("signsgd", 6_553_600, (819_204,)),
    ("qsgd", 6_553_600, (6_553_604,)),
    ("terngrad", 6_553_600, (6_553_604,)),
    ("randomk", 6_553_600, (262_144,)),
    ("mstopk", 6_553_600, (524_288,)),
    ("ef:signsgd", 6_553_600, (819_204,)),
    ("powersgd", 5_597_184, None),               # its last bucket
    ("signsgd", 5_597_184, None),
    ("qsgd", 5_597_184, None),
    ("mstopk", 5_597_184, None),
    ("ef:randomk", 5_597_184, None),
    ("none", 1000, (4000,)),
])
def test_wire_round_bytes_match_jax(comp_name, n, want):
    got = tbase.make(comp_name).wire_round_bytes(n)
    assert got == jbase.make(comp_name).wire_round_bytes(n)
    if want is not None:
        assert got == want


def test_payload_wire_spec_matches_jax():
    g = np.linspace(-1, 1, 1000, dtype=np.float32)
    jp = jbase.make("signsgd").encode(jax.numpy.asarray(g),
                                      jbase.make("signsgd").init_state(
                                          1000, jax.random.key(0)))
    tcomp = tbase.make("signsgd")
    tp = tcomp.encode(torch.from_numpy(g), tcomp.init_state(1000))
    assert tp.nbytes == jp.nbytes
    spec = tp.wire_spec()
    jspec = jp.wire_spec()
    assert {k: (v["shape"], v["nbytes"]) for k, v in spec.items()} == \
        {k: (v["shape"], v["nbytes"]) for k, v in jspec.items()}


@pytest.mark.parametrize("kind", ["auto", "allreduce",
                                  "reduce_scatter_allgather", "gather_all",
                                  "reduce_to_owner_broadcast"])
def test_mean_reduce_is_identity_mean_on_one_rank(kind):
    t = torch.randn(37)
    out = tcp.mean_reduce(t, ("data",), tcp.CommPlan(kind))
    assert torch.equal(out, t)
    assert out.data_ptr() != t.data_ptr()    # a new tensor, as pmean gives


def test_reduce_payload_gathers_with_a_peer_axis():
    x = torch.arange(10, dtype=torch.int32)
    red = tbase.reduce_payload(
        tbase.Payload({"x": x, "s": torch.tensor(2.0)}, associative=False),
        ("data",))
    assert red.tensors["x"].shape == (1, 10) and red.tensors["s"].shape == (1,)
    assert torch.equal(red.tensors["x"][0], x) and red.local["x"] is x


@pytest.mark.parametrize("kind", ["hierarchical"])
def test_unported_comm_plans_raise(kind):
    """``hierarchical`` is ported (tests/test_torch_pod.py): it raises only
    where the JAX package does, for an ``intra`` that names no axis of the
    reduction; on one rank it is the identity mean."""
    t = torch.randn(3)
    with pytest.raises(tcp.CommPlanError):
        tcp.mean_reduce(t, ("data",), tcp.CommPlan(kind, intra=("pod",)))
    assert torch.equal(tcp.mean_reduce(t, ("data",), tcp.CommPlan(kind)), t)


@pytest.mark.parametrize("spec", ["auto", "allreduce", "gather_all",
                                  "hierarchical", "hierarchical:pod+data",
                                  "reduce_scatter_allgather",
                                  "reduce_to_owner_broadcast"])
def test_commplan_copy_matches_jax(spec):
    t, j = tcp.CommPlan.parse(spec), jcp.CommPlan.parse(spec)
    assert t.to_json() == j.to_json() and t.spec_str() == j.spec_str()
    for assoc in (True, False):
        assert t.legal_for(assoc) == j.legal_for(assoc)
    for p in (1, 4, 8):
        assert t.wire_bytes(1e6, p, 1.5, 2) == j.wire_bytes(1e6, p, 1.5, 2)


def test_registry_and_plan_kwargs():
    assert set(tbase.registry()) == set(jbase.registry()) == {
        "none", "powersgd", "signsgd", "qsgd", "terngrad", "randomk",
        "mstopk"}
    plan = dataclasses.make_dataclass(
        "PlanStub", ["compression", "powersgd_rank", "error_feedback",
                     "qsgd_bits", "topk_frac"])
    for name in ("powersgd", "signsgd", "qsgd", "terngrad", "randomk",
                 "mstopk", "ef:qsgd", "ef:mstopk"):
        stub = plan(name, 7, False, 4, 0.05)
        assert tbase.plan_kwargs(stub) == jbase.plan_kwargs(stub), name
    assert tbase.plan_kwargs(plan("powersgd", 7, False, 8, 0.01)) == \
        {"rank": 7}
    assert tbase.from_plan(plan("powersgd", 7, False, 8, 0.01)).rank == 7
    assert tbase.from_plan(plan("ef:qsgd", 7, True, 4, 0.01)).inner.levels \
        == 7


@pytest.mark.parametrize("name", ["qsgd", "terngrad", "randomk", "mstopk",
                                  "signsgd"])
def test_ef_wrapper_owns_the_one_residual(name):
    """``ef:`` forces the inner switch off, keeps its associativity and
    names, and matches the JAX wrapper's."""
    t, j = tbase.make(f"ef:{name}", error_feedback=True), \
        jbase.make(f"ef:{name}", error_feedback=True)
    assert t.inner.error_feedback is False is j.inner.error_feedback
    assert (t.associative, t.name) == (j.associative, j.name)
    st = t.init_state(100)
    assert st.residual.shape == (100,) and st.inner.err.shape == (1,)


def test_ef_powersgd_raises_in_both_packages():
    for base in (tbase, jbase):
        with pytest.raises(ValueError, match="compensate twice"):
            base.make("ef:powersgd")
    assert tbase.make("powersgd").builtin_error_feedback
    assert not tbase.make("signsgd").builtin_error_feedback


def test_keys_stay_on_the_host_and_split_like_jax_keys():
    """A key is drawn per state from the generator, split deterministically
    into a new carry and a different sub, and seeds draws without leaving
    the host."""
    gen = torch.Generator().manual_seed(3)
    keys = [tbase.make("qsgd").init_state(10, gen).key for _ in range(3)]
    assert all(k.device.type == "cpu" and k.dtype == torch.int64
               for k in keys)
    assert len({tuple(k.tolist()) for k in keys}) == 3
    carry, sub = tbase.split_key(keys[0])
    assert torch.equal(carry, tbase.split_key(keys[0])[0])
    assert not torch.equal(carry, sub) and not torch.equal(carry, keys[0])
    u0 = tqsgd.uniform(keys[0], 0, 1000, "cpu")
    assert torch.equal(u0, tqsgd.uniform(keys[0], 0, 1000, "cpu"))
    assert not torch.equal(u0, tqsgd.uniform(keys[0], 1, 1000, "cpu"))
    assert tbase.key_generator(keys[0], "meta") is None


def test_randomk_draws_the_same_indices_in_encode_and_decode():
    """decode re-derives encode's indices from the same key: the
    aggregate of one rank puts every sent value back where it came
    from, and the next step draws new indices."""
    comp = tbase.make("randomk", error_feedback=False)
    st = comp.init_state(10_000, torch.Generator().manual_seed(0))
    g = torch.randn(10_000)
    out, new = comp.aggregate(g, st, ("data",))
    kept = out != 0
    assert int(kept.sum()) == comp.k_for(10_000)
    assert torch.equal(out[kept], g[kept])
    out2, _ = comp.aggregate(g, new, ("data",))
    assert not torch.equal(out2 != 0, kept)
