"""The port's arch registry, shapes and parameter accounting against the
JAX package's (``repro.configs``, ``repro.models.registry``).

* All ten ``ArchConfig``s, their ``reduced()`` forms, ``SHAPES`` and
  ``applicable`` equal JAX's field for field (``dataclasses.asdict``).
* ``param_count`` and ``active_param_count`` equal JAX's exactly at full
  size for every arch the port builds (counted on the ``meta`` device),
  and ``model_flops`` equals JAX's.
* The vlm family, the last the port lacked, builds: ``Model``,
  ``param_count`` (JAX's count) and ``train_step.build`` on its own plan
  (FSDP) no longer raise ``NotImplementedError``.
* ``adaptive.controller``'s parameter count goes through the registry, so
  ``resolve_plan`` runs for the MoE, hybrid, ssm and audio archs (they
  raised before).
"""
import dataclasses

import pytest

from repro.configs import base as jcfgs
from repro.configs import shapes as jshapes
from repro.models import registry as jregistry
from repro_torch.configs import base as tcfgs
from repro_torch.configs import shapes as tshapes
from repro_torch.models import registry as tregistry

NAMES = ["arctic-480b", "granite-8b", "mistral-nemo-12b", "qwen2-moe-a2.7b",
         "qwen2-vl-7b", "qwen3-32b", "seamless-m4t-medium", "tinyllama-1.1b",
         "xlstm-350m", "zamba2-2.7b"]
#: arch -> (parameters, active parameters) at full size: JAX's registry
COUNTS = {
    "tinyllama-1.1b": (1_100_048_384, 1_100_048_384),
    "granite-8b": (8_254_689_280, 8_254_689_280),
    "mistral-nemo-12b": (12_772_070_400, 12_772_070_400),
    "qwen3-32b": (30_497_192_960, 30_497_192_960),
    "qwen2-moe-a2.7b": (14_315_636_736, 2_689_026_048),
    "arctic-480b": (476_850_275_328, 15_584_314_368),
    "zamba2-2.7b": (2_440_081_568, 2_440_081_568),
    "xlstm-350m": (314_143_912, 314_143_912),
    "seamless-m4t-medium": (877_094_912, 877_094_912),
    "qwen2-vl-7b": (7_615_487_488, 7_615_487_488),
}
#: the families the port did not build before the vlm slice: arch ->
#: family (each now builds on its own plan and counts as JAX does)
NOT_PORTED = {"qwen2-vl-7b": "vlm"}


def test_every_arch_is_registered():
    assert tcfgs.names() == jcfgs.names() == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_arch_config_equals_jax(name):
    assert dataclasses.asdict(tcfgs.get(name)) == \
        dataclasses.asdict(jcfgs.get(name))


@pytest.mark.parametrize("name", NAMES)
def test_reduced_config_equals_jax(name):
    got = tcfgs.reduced(tcfgs.get(name))
    want = jcfgs.reduced(jcfgs.get(name))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    over = dict(n_layers=3, d_model=64)
    assert dataclasses.asdict(tcfgs.reduced(tcfgs.get(name), **over)) == \
        dataclasses.asdict(jcfgs.reduced(jcfgs.get(name), **over))


def test_shapes_equal_jax():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for k, s in tshapes.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jshapes.SHAPES[k])
        assert dataclasses.asdict(tshapes.get(k)) == \
            dataclasses.asdict(jshapes.get(k))


@pytest.mark.parametrize("name", NAMES)
def test_applicable_equals_jax(name):
    for k in tshapes.SHAPES:
        assert tshapes.applicable(tcfgs.get(name), tshapes.SHAPES[k]) == \
            jshapes.applicable(jcfgs.get(name), jshapes.SHAPES[k])


@pytest.mark.parametrize("name", list(COUNTS))
def test_param_counts_equal_jax(name):
    total, active = COUNTS[name]
    cfg = tcfgs.get(name)
    assert cfg.param_count() == tregistry.param_count(cfg) == total
    assert cfg.active_param_count() == active
    jcfg = jcfgs.get(name)
    assert (jcfg.param_count(), jcfg.active_param_count()) == (total, active)
    for tokens, training in ((4096, True), (512, False)):
        assert tregistry.model_flops(cfg, tokens, training) == \
            jregistry.model_flops(jcfg, tokens, training)


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


@pytest.mark.parametrize("name", list(NOT_PORTED))
def test_unported_families_raise_naming_the_family(name, own_world):
    """The family the port refused until the vlm slice now builds: the
    model on ``meta``, JAX's parameter count, and the step on the arch's
    own plan (FSDP; one rank drops the size-1 FSDP axis) and on DDP."""
    from repro_torch.models.model import FAMILIES, Model
    from repro_torch.train import train_step as tts
    fam = NOT_PORTED[name]
    assert fam in FAMILIES
    cfg = tcfgs.get(name)
    model = Model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() == jcfgs.get(name).param_count() == COUNTS[name][0]
    setup = tts.build(tcfgs.reduced(cfg), "cpu")
    assert setup.arch.plan.dp_mode == "fsdp" and setup.fsdp_axes == ()
    assert tts.build(tcfgs.reduced(cfg), "cpu", dp_mode="ddp").zero1 is \
        False


def test_controller_param_count_goes_through_the_registry():
    """``_param_count`` built ``Model`` itself before, so it already gave
    these numbers for the dense archs; that it equals the registry's for
    the MoE, hybrid and ssm archs too is what ``resolve_plan`` on them
    needs."""
    from repro_torch.adaptive import controller as actl
    for name, (total, _) in COUNTS.items():
        assert actl._param_count(tcfgs.get(name)) == total
    assert actl._param_count(tcfgs.get("xlstm-350m")) == 314_143_912 == \
        jcfgs.get("xlstm-350m").param_count()
