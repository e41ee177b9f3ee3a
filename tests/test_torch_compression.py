"""PowerSGD and SignSGD aggregation on one rank: the port on a one-rank gloo
group against the JAX package on a one-device ``data`` mesh, from the same
bucket and carried-over state; wire bytes; the CommPlan copy; the
compressor registry of the slice.

Tolerances: outputs and new state to ``rtol=1e-5, atol=1e-5`` (fp32 in
both, summed in different orders; the bucket values are of order one);
SignSGD's signs exactly.
"""
import dataclasses

import jax
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
    rng = np.random.default_rng(seed)
    bucket = rng.standard_normal(n).astype(np.float32)
    jcomp = jbase.make(comp_name)
    jstate = jcomp.init_state(n, jax.random.key(seed))
    # a live error-feedback residual, carried over to both sides
    err = (0.1 * rng.standard_normal(n)).astype(np.float32)
    jstate = jstate._replace(err=jax.numpy.asarray(err))
    return bucket, jcomp, jstate


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("comp_name", ["powersgd", "signsgd"])
def test_aggregate_matches_jax_on_one_rank(comp_name, n):
    bucket, jcomp, jstate = _inputs(comp_name, n, n)
    jout, jnew = _jax_aggregate(jcomp, bucket, jstate)
    tcomp = tbase.make(comp_name)
    (tstate,) = convert.agg_states(tcomp, [jax.device_get(jstate)],
                                   index=None)
    tout, tnew = tcomp.aggregate(torch.from_numpy(bucket), tstate, ("data",))
    np.testing.assert_allclose(tout.numpy(), jout, rtol=1e-5, atol=1e-5)
    for name in tnew._fields:
        np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                   np.asarray(getattr(jnew, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if comp_name == "signsgd":
        np.testing.assert_array_equal(np.sign(tout.numpy()), np.sign(jout))


@pytest.mark.parametrize("comp_name,n,want", [
    ("powersgd", 6_553_600, (40_960, 40_960)),   # full tinyllama bucket
    ("signsgd", 6_553_600, (819_204,)),
    ("powersgd", 5_597_184, None),               # its last bucket
    ("signsgd", 5_597_184, None),
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
                                  "reduce_scatter_allgather", "gather_all"])
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


@pytest.mark.parametrize("kind", ["hierarchical", "reduce_to_owner_broadcast"])
def test_unported_comm_plans_raise(kind):
    with pytest.raises(NotImplementedError):
        tcp.mean_reduce(torch.ones(3), ("data",), tcp.CommPlan(kind))


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
    assert set(tbase.registry()) == {"none", "powersgd", "signsgd"}
    plan = dataclasses.make_dataclass(
        "PlanStub", ["compression", "powersgd_rank", "error_feedback"])
    assert tbase.plan_kwargs(plan("powersgd", 7, False)) == {"rank": 7}
    assert tbase.plan_kwargs(plan("signsgd", 7, False)) == \
        {"error_feedback": False}
    assert tbase.from_plan(plan("powersgd", 7, False)).rank == 7


@pytest.mark.parametrize("name", ["qsgd", "mstopk", "randomk", "terngrad",
                                  "ef:signsgd"])
def test_unported_compressors_raise(name):
    assert name.removeprefix("ef:") in jbase.registry()
    with pytest.raises(NotImplementedError):
        tbase.make(name)
