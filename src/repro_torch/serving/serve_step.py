"""Serving steps: prefill and one-token decode with a sharded KV cache.
Counterpart of ``repro.serving.serve_step``.

On the current process group's mesh (``launch.mesh``; one rank when
there is none yet):

  * parameters: TP over ``model``; under the plan's ``serve_fsdp``
    (``qwen3-32b``) also FSDP over the DP axes of size > 1, gathered at
    use (``layers.fsdp_gather``); under ``serve_moe_ep_data``
    (``arctic-480b``) with a ``data`` axis of size > 1, the 2-D MoE layout
    (experts over ``data``, ``d_ff`` over ``model``; ``models.moe``);
  * cache: the batch over the DP axes, the kv heads over ``model``;
  * context parallelism, exactly when the global batch is smaller than the
    DP degree: every rank takes the whole batch, the cache's sequence dim
    is sharded over the DP axes and the partial attention is merged by
    log-sum-exp (``attention.decode_attention``).

``make_prefill`` and ``make_decode`` are plain callables: each takes the
GLOBAL batch (host arrays or tensors), gives this rank its rows
(``batch_rows``, the JAX package's ``batch_specs``), and returns the
global ``(B, V_pad)`` logits on every rank, gathered over ``model``
(the vocabulary) and over the DP axes (the batch) unless context
parallelism replicates them, so that sampling gives the same tokens
everywhere.  The cache is allocated once by prefill (``Model.new_cache``)
and written in place by every decode step.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.layers import ShardCtx
from repro_torch.models.model import Model, check_serving
from repro_torch.parallel import collectives as coll

@dataclasses.dataclass
class ServeSetup:
    arch: ArchConfig
    model: Model
    ctx: ShardCtx
    dp_axes: tuple[str, ...]
    context_parallel: bool
    global_batch: int
    cache_len: int                      # global capacity
    batch_local: int
    cache_len_local: int
    cache_dtype: torch.dtype = torch.bfloat16

    @property
    def p_dp(self) -> int:
        sizes = mesh_mod.axis_sizes()
        return math.prod(sizes.get(a, 1) for a in self.dp_axes)

    @property
    def device(self) -> torch.device:
        return self.model.embed.table.device


def build_serve(arch: ArchConfig, shape: ShapeConfig,
                param_dtype: torch.dtype = torch.bfloat16,
                device: "str | torch.device | None" = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> ServeSetup:
    """The serving setup of ``arch`` for ``shape`` (its ``seq_len`` the
    cache's capacity, its ``global_batch`` the batch) on the current
    mesh, on the card unless ``device="cpu"``.  The parameters are
    allocated and not drawn (``serve_params``).  The JAX package fixes
    the compute dtype to bf16; ``compute_dtype`` lets a test run fp32."""
    check_serving(arch)
    dev = mesh_mod.local_device(device or "cuda")
    mesh_mod.init_world(dev)
    sizes = mesh_mod.axis_sizes()
    tp = mesh_mod.tp_size()
    dp_axes = mesh_mod.present_axes()
    p_dp = math.prod(sizes.get(a, 1) for a in dp_axes)
    context_parallel = shape.global_batch < p_dp
    fsdp_axes = tuple(a for a in dp_axes if sizes.get(a, 1) > 1) \
        if arch.plan.serve_fsdp else ()
    moe_ep = "data" if arch.plan.serve_moe_ep_data \
        and sizes.get("data", 1) > 1 else None
    ctx = ShardCtx(compute_dtype=compute_dtype, param_dtype=param_dtype,
                   fsdp_axes=fsdp_axes, tp=tp, seq_parallel=False,
                   cache_seq_axes=dp_axes if context_parallel else (),
                   moe_ep_axis=moe_ep)
    if not context_parallel and shape.global_batch % p_dp:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"split over {p_dp} DP ranks")
    batch_local = shape.global_batch if context_parallel \
        else shape.global_batch // p_dp
    cp_deg = p_dp if context_parallel else 1
    if shape.seq_len % cp_deg:
        raise ValueError(f"cache length {shape.seq_len} does not split "
                         f"over {cp_deg} context-parallel ranks")
    return ServeSetup(arch=arch, model=Model(arch, ctx, device=dev),
                      ctx=ctx, dp_axes=dp_axes,
                      context_parallel=context_parallel,
                      global_batch=shape.global_batch,
                      cache_len=shape.seq_len, batch_local=batch_local,
                      cache_len_local=shape.seq_len // cp_deg)


def batch_rows(setup: ServeSetup, batch: dict) -> dict:
    """This rank's part of a global batch, on the model's device: its
    rows over the DP axes (dim 1 of ``mrope_positions``, dim 0 of every
    other input), or the whole batch under context parallelism."""
    split = not setup.context_parallel and setup.p_dp > 1
    i = mesh_mod.rank(setup.dp_axes) if split else 0
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if split:
            v = v.narrow(1 if k == "mrope_positions" else 0,
                         i * setup.batch_local, setup.batch_local)
        out[k] = v.to(setup.device)
    return out


def gather_logits(setup: ServeSetup, logits: torch.Tensor) -> torch.Tensor:
    """This rank's (B_local, V_pad / tp) logits -> the global (B, V_pad):
    gathered over ``model`` along the vocabulary and over the DP axes
    along the batch (not under context parallelism, whose ranks hold the
    whole batch)."""
    if setup.ctx.tp > 1:
        logits = coll.all_gather(logits, ("model",), 1)
    if not setup.context_parallel and setup.p_dp > 1:
        logits = coll.all_gather(logits, setup.dp_axes, 0)
    return logits


def make_prefill(setup: ServeSetup):
    """``prefill(batch) -> (global last-position logits, cache)``: a new
    cache of this rank's shape, filled by ``Model.prefill``."""
    model = setup.model

    def prefill(batch: dict):
        cache = model.new_cache(setup.batch_local, setup.cache_len_local,
                                setup.cache_dtype)
        logits, cache = model.prefill(batch_rows(setup, batch), cache)
        return gather_logits(setup, logits), cache
    return prefill


def make_decode(setup: ServeSetup):
    """``decode(cache, batch) -> (global logits, cache)``; batch:
    ``tokens`` (B, 1), ``cur_len`` (B,) [, ``mrope_positions`` (3, B,
    1)].  The cache is written in place."""
    model = setup.model

    def decode(cache: dict, batch: dict):
        logits, cache = model.decode(cache, batch_rows(setup, batch))
        return gather_logits(setup, logits), cache
    return decode


def serve_params(setup: ServeSetup,
                 generator: "torch.Generator | None" = None) -> Model:
    """Draw ``setup.model``'s parameters in place (random serving weights
    for examples and tests; a deployment loads a checkpoint or
    ``convert.load_params``) with ``Model.init_params``, as the JAX
    package's ``serve_params`` calls the training init: one seed (0 on
    the model's device when ``generator`` is None) gives the same global
    weights on any mesh.  Returns the model."""
    if generator is None:
        generator = torch.Generator(device=setup.device).manual_seed(0)
    setup.model.init_params(generator)
    return setup.model
