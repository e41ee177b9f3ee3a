"""The overlapped DDP step: bucketed gradient aggregation issued during the
backward pass, the paper's *optimized* syncSGD baseline (§2.2, Fig 2).
Counterpart of ``repro.train.overlap``.

The classic step (``train_step.make_step``) runs the whole backward and
only then aggregates every bucket.  This module runs the backward one
stage at a time and aggregates each bucket as soon as its gradients are
final:

  1. The model's blocks are split into stages.  The forward runs each
     block on a detached input and on detached per-layer slices of the
     stacked weights, keeping one autograd graph per block (with
     ``remat="full"`` each graph saves only its input); the backward calls
     ``torch.autograd.grad`` on those graphs in reverse layer order.  Stage
     ``s`` is block ``L - 1 - s``; stage ``L`` (the tail) is the loss head
     and the embedding, whose gradients are final last.  Every stage runs
     the code of the classic step (``Model.stage_embed``,
     ``Model.stage_block``, ``Model.stage_loss``).
  2. The gradients are bucketed with the leaf-aligned layout
     (``bucketing.layout_from_leaf_sizes``) over the leaves in
     backward-completion order: the last block's leaves first, block 0's
     next to last, then the tail.  No leaf straddles a bucket boundary, so
     a bucket is complete after the stage that writes its last leaf
     (``OverlapLayout.bucket_ready``).
  3. Under ``schedule="overlap"`` each completed bucket's encode -> reduce
     -> decode (``GradAggregator.aggregate_one``) is issued right after
     that stage, on a side CUDA stream, so the card runs it beside the
     next stage's backward.  ``schedule="serial"`` issues the same flushes
     on the same side stream after the whole backward.  The two differ
     only in the order of issue and give the same bits.

Where the JAX package needs ``jax.lax.optimization_barrier`` and XLA's
latency-hiding-scheduler flags (``enable_overlap_flags``) to keep the
collectives between the backward stages, the port needs neither: eager
PyTorch issues work in program order, and the side stream lets the card
run a flush beside the compute stream.  ``torch.distributed``'s collectives
make the *current* stream wait for them; inside the flush that is the side
stream, so the next stage's backward does not wait.  On the CPU (gloo)
there are no streams and the schedule is only the order of issue.

Which plans pipeline is decided by the resolved comm plan
(``commplan.OVERLAPPABLE``): ``gather_all``, the forced resolution of the
non-associative schemes, needs every peer before any decode, so it runs
``serial``; ``reduce_to_owner_broadcast`` has no per-bucket collective at
all (the exchange is folded into ZeRO-1's update), so the backward runs
``raw``.  ``effective_schedule`` reports the resolution.

The MoE family's blocks also return a load-balancing loss: each block's
backward is seeded with ``MOE_AUX_COEF / (L * aux_div)`` on that
output, the derivative of the classic step's ``MOE_AUX_COEF * mean /
aux_div`` (``p_fsdp``, times ``tp`` under SP),
and the step reports the mean over the layers as ``moe_aux``.

The hybrid family's stage is a zamba2 group, whose leaves (``groups.``)
sit between ``final_norm`` and ``shared`` in the leaf order: the layout
picks the stack by its prefix, wherever it sits, and the tail is the
rest in parameter order.  Every group reads the shared block; its
gradient is summed over the groups' backwards and flushed with the tail.
The ssm family's stage is an xLSTM group (its mLSTM blocks and its sLSTM
block), whose leaves sit between ``final_norm`` and ``unembed``; it has
no shared leaves, so its tail is the embedding, the final norm and the
unembedding, as in the dense family.

The audio family has two stacks (``Model.stacks``): the decoder's blocks
are stages ``0..L_dec-1`` and the encoder's are the stages after them,
the order in which the backward completes them.  Every decoder block
reads the encoder's memory as a detached input of its own graph; the
backward sums the memory's gradient over the decoder blocks, takes it
through ``enc_norm``, then runs the encoder blocks in reverse
(``_backward_encdec``).  Its tail is the embedding, ``enc_norm``, the
final norm and the unembedding.

The vlm family's stage is a dense block rotating by M-RoPE over the
batch's ``mrope_positions``; its first stage takes the batch's
``embeds`` (cast to the compute dtype) in place of the token lookup, so
no gradient reaches ``embed.table``, whose gradient is zero, as in the
JAX package's ``f_in``.

Supported: every family (dense, vlm, MoE, hybrid, ssm and audio), ZeRO-1
through ``train_step.zero1_apply`` on the ordered leaves, and ``accum >
1`` (microbatches 0..N-2 run ``raw`` into an fp32 sum; each bucket is
flushed once, during the final microbatch's backward).  FSDP is refused
with the JAX package's ``ValueError``.

Tensor parallelism: each stage's graph holds its ``model`` collectives
(``models.layers``), run by its backward on the main thread in stage
order, the same on every rank; the flushes reduce over the DP group of
this rank's model index, another group, so the two orders never
interleave within a group.  Under SP the embedding stage ends in the
sequence reduce-scatter of the token lookup, or in the slice of
``layers.sp_scatter_embeds`` (precomputed embeddings, frames), so each
stage's detached input is this rank's slice of the sequence; the audio
decoder's memory leaf is whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.core import aggregator as agg_mod
from repro_torch.core import bucketing
from repro_torch.models.model import FAMILIES, positions_of
from repro_torch.parallel import commplan as cp


# --------------------------------------------------------------------------
# support gating
# --------------------------------------------------------------------------
def supports(arch, plan) -> tuple[bool, str]:
    """Can (arch, plan) run the segmented overlapped step?"""
    if plan.dp_mode != "ddp":
        return False, ("overlap interleaves DDP bucket collectives; FSDP's "
                       "per-layer reduce-scatter already overlaps via the "
                       "all_gather AD transpose")
    if arch.family not in FAMILIES:
        return False, f"family {arch.family!r} has no scanned block " \
                      "stack to segment"
    return True, ""


def check_supported(arch, plan) -> None:
    """Raises ``ValueError`` for a plan or a family the segmented step
    cannot run."""
    ok, why = supports(arch, plan)
    if not ok:
        raise ValueError(f"plan.overlap unsupported for {arch.name}: {why}")


def effective_schedule(setup) -> str:
    """The schedule ``make_step(schedule="overlap")`` runs, resolved from
    the comm plan: ``"overlap"`` for the ring plans of
    ``commplan.OVERLAPPABLE``; ``"serial"`` for ``gather_all`` (every
    peer's payload is needed before any decode); ``"raw"`` under
    ``reduce_to_owner_broadcast``, which has no per-bucket collective."""
    if setup.rtob:
        return "raw"
    if not setup.agg_cfg.compress_axes and not setup.agg_cfg.raw_axes:
        return "overlap"      # no collectives at all; the schedule is moot
    if setup.agg_cfg.compressor == "none":
        assoc = True
    else:
        assoc = setup.agg_cfg.build().associative
    resolved = setup.agg_cfg.comm.resolve(assoc)
    return "overlap" if resolved.kind in cp.OVERLAPPABLE else "serial"


# --------------------------------------------------------------------------
# layout: leaves ordered by backward completion
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StackSeg:
    """One stacked block collection's slice of the ordered-leaf space."""
    key: str                      # parameter prefix of the collection
    n_layers: int                 # backward stages contributed
    n_leaves: int                 # leaves per layer slice
    stage0: int                   # first stage index of this stack
    leaf0: int                    # first ordered-leaf index of this stack

    @property
    def leaf_end(self) -> int:
        return self.leaf0 + self.n_layers * self.n_leaves


@dataclasses.dataclass(frozen=True)
class OverlapLayout:
    """Leaf-aligned bucket layout over backward-completion-ordered leaves.

    Leaf order, stack by stack (``Model.stacks``): its last block's leaves
    first, block 0's last; then the tail (every parameter outside the
    stacks, in parameter order: embedding, the audio family's
    ``enc_norm``, final norm, the hybrid family's shared block,
    unembedding).  Stage ``s`` is one block's (or group's) backward; stage
    ``n_stages`` is the tail, final only once the whole backward,
    embedding included, has run.
    """
    layout: bucketing.BucketLayout
    stacks: tuple[StackSeg, ...]
    n_stages: int                  # total block stages (tail == n_stages)
    bucket_ready: tuple[int, ...]  # bucket -> stage after which complete
    #: per stack, its leaves' positions in parameter order; then the tail
    #: leaves' positions in parameter order
    stack_params: tuple[tuple[int, ...], ...]
    rest: tuple[int, ...]

    def stage_leaf_range(self, s: int) -> tuple[int, int]:
        """Half-open ordered-leaf range written by stage ``s``."""
        for seg in self.stacks:
            if s < seg.stage0 + seg.n_layers:
                lo = seg.leaf0 + (s - seg.stage0) * seg.n_leaves
                return lo, lo + seg.n_leaves
        return self.stacks[-1].leaf_end, len(self.layout.leaf_sizes)

    def buckets_ready_at(self, s: int) -> list[int]:
        return [b for b, r in enumerate(self.bucket_ready) if r == s]


def layout_for_model(model, bucket_mb: float) -> OverlapLayout:
    """The overlap layout of a ``Model`` (any device, ``meta`` included:
    only shapes and dtypes are read)."""
    names, params = zip(*model.named_parameters())
    segs, stacks, leaf_sizes = [], [], []
    stage0 = leaf0 = 0
    for prefix, n_layers in model.stacks:
        # each stack picked by its prefix, wherever it sits in the leaf
        # order (the hybrid family's groups sit between final_norm and
        # shared), as the JAX package's _split_params picks it
        stack = tuple(i for i, name in enumerate(names)
                      if name.startswith(prefix))
        per_layer = [math.prod(params[i].shape[1:]) for i in stack]
        segs.append(StackSeg(prefix[:-1], n_layers, len(per_layer), stage0,
                             leaf0))
        stacks.append(stack)
        leaf_sizes += per_layer * n_layers
        stage0 += n_layers
        leaf0 += len(per_layer) * n_layers
    in_stack = set().union(*stacks)
    rest = tuple(i for i in range(len(params)) if i not in in_stack)
    leaf_sizes += [params[i].numel() for i in rest]
    dtype = bucketing._majority_dtype(params)
    layout = bucketing.layout_from_leaf_sizes(leaf_sizes, dtype, bucket_mb)

    def stage_of(leaf_idx: int) -> int:
        for seg in segs:
            if leaf_idx < seg.leaf_end:
                return seg.stage0 + (leaf_idx - seg.leaf0) // seg.n_leaves
        return stage0

    ready = tuple(stage_of(layout.bucket_leaves(b)[1] - 1)
                  for b in range(layout.n_buckets))
    return OverlapLayout(layout, tuple(segs), stage0, ready, tuple(stacks),
                         rest)


def build_layout(setup) -> OverlapLayout:
    """The overlap layout of a TrainSetup, memoized on the setup (keyed by
    the bucket byte target, as in the JAX package): the compressor
    states, the ZeRO-1 owner plan and the step all read it."""
    cached = getattr(setup, "_overlap_layout_cache", None)
    if cached is not None and cached[0] == setup.agg_cfg.bucket_mb:
        return cached[1]
    check_supported(setup.arch, setup.arch.plan)
    ov = layout_for_model(setup.model, setup.agg_cfg.bucket_mb)
    setup._overlap_layout_cache = (setup.agg_cfg.bucket_mb, ov)
    return ov


# --------------------------------------------------------------------------
# the flush engine
# --------------------------------------------------------------------------
class _Flush:
    """Ordered-leaf store and per-bucket flush of one segmented backward.

    ``stage(s, leaves)`` stores stage ``s``'s leaf gradients (added to the
    fp32 sum ``acc`` of the earlier microbatches and scaled by
    ``inv_accum`` on a final microbatch) and, under ``overlap``, flushes
    the buckets completed by stage ``s``.  ``tail(leaves)`` stores the
    tail, flushes the remaining buckets (all of them under ``serial``),
    joins the side stream and returns the aggregated ordered leaves.

    On the card every flush runs on ``side`` after ``side`` waits for the
    compute stream; the compute stream waits for ``side`` once, in
    ``tail``.  The stored leaves are compute-stream tensors read on
    ``side``: they are held until after that join, so the caching
    allocator cannot hand their memory out early.  The buckets, the
    aggregated buckets and the new compressor states are side-stream
    tensors: the compute stream reads them only after the join, and every
    later side-stream use first waits for the compute stream.

    Uncompressed buckets under a plan of ``commplan.ASYNC_KINDS`` issue
    their collectives with ``async_op=True`` (``GradAggregator.start_one``):
    a gloo collective issued synchronously blocks the host until it ends,
    and would hold back the next stage's backward.  Each stage moves the
    means in flight on, oldest first, without blocking (a hierarchical
    mean's ``pod`` leg is issued once its ``data`` leg has arrived), and
    ``tail`` waits for the rest before the join.  A compressed bucket's
    collectives stay synchronous: PowerSGD's second round needs the
    first's result, and the decode needs both.
    """

    def __init__(self, ov: OverlapLayout, aggregator: agg_mod.GradAggregator,
                 agg_states: tuple, schedule: str, do_agg: bool,
                 side: Optional["torch.cuda.Stream"] = None,
                 acc: Optional[list] = None, inv_accum: float = 1.0):
        self.ov, self.aggregator, self.schedule = ov, aggregator, schedule
        self.states = agg_states
        self.do_agg = do_agg and schedule != "raw"
        self.side = side
        self.main = torch.cuda.current_stream(side.device) if side else None
        self.acc, self.inv = acc, inv_accum
        n_buckets = ov.layout.n_buckets
        self.leaf_vals: list = [None] * len(ov.layout.leaf_sizes)
        self.out_buckets: list = [None] * n_buckets
        self.new_states: list = list(agg_states) if agg_states \
            else [() for _ in range(n_buckets)]
        #: (bucket, stage after which it was issued), in order of issue
        self.order: list[tuple[int, int]] = []
        #: the asynchronous means in flight: (bucket, PendingMean), oldest
        #: first
        self.pending: list = []
        self.async_mean = self.do_agg \
            and aggregator.cfg.compressor == "none" \
            and aggregator.cfg.comm.resolve(True).kind in cp.ASYNC_KINDS

    def _store(self, s: int, leaves: Sequence[torch.Tensor]) -> None:
        lo, hi = self.ov.stage_leaf_range(s)
        if len(leaves) != hi - lo:
            raise ValueError(f"stage {s}: {len(leaves)} leaves for "
                             f"[{lo}, {hi})")
        if self.acc is not None:
            # (g + sum) * (1 / accum) in place in the fp32 sum: the bits
            # of the JAX package's (g.astype(f32) + sum) * inv, without a
            # second fp32 copy of the gradient
            leaves = [self.acc[lo + i].add_(v).mul_(self.inv)
                      for i, v in enumerate(leaves)]
        self.leaf_vals[lo:hi] = leaves

    def _side_stream(self):
        if self.side is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.side)

    def _on_side(self):
        if self.side is not None:
            self.side.wait_stream(self.main)
        return self._side_stream()

    def _flush(self, b: int, s: int) -> None:
        layout = self.ov.layout
        lo, hi = layout.bucket_leaves(b)
        with self._on_side():
            parts = [v.reshape(-1).to(layout.dtype)
                     for v in self.leaf_vals[lo:hi]]
            bucket = parts[0] if len(parts) == 1 else torch.cat(parts)
            if self.async_mean:
                self.pending.append((b, self.aggregator.start_one(bucket)))
            else:
                st = self.states[b] if self.states else ()
                self.out_buckets[b], self.new_states[b] = \
                    self.aggregator.aggregate_one(bucket, st)
        self.order.append((b, s))

    def _poll(self) -> None:
        """Move the means in flight on, oldest first, stopping at the first
        unfinished one, so every rank issues each group's collectives in
        bucket order."""
        if not self.pending:
            return
        with self._side_stream():
            while self.pending and self.pending[0][1].poll():
                b, mean = self.pending.pop(0)
                self.out_buckets[b] = mean.wait()

    def stage(self, s: int, leaves: Sequence[torch.Tensor]) -> None:
        self._store(s, leaves)
        if self.do_agg and self.schedule == "overlap":
            for b in self.ov.buckets_ready_at(s):
                self._flush(b, s)
        self._poll()

    def tail(self, leaves: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        ov = self.ov
        self._store(ov.n_stages, leaves)
        if self.do_agg:
            todo = ov.buckets_ready_at(ov.n_stages) \
                if self.schedule == "overlap" else range(ov.layout.n_buckets)
            for b in todo:
                self._flush(b, ov.n_stages)
            with self._side_stream():
                for b, mean in self.pending:
                    self.out_buckets[b] = mean.wait()
            self.pending = []
            if self.side is not None:
                self.main.wait_stream(self.side)
            out = bucketing.buckets_to_leaves(self.out_buckets,
                                              self.leaf_vals, ov.layout)
        else:
            out = self.leaf_vals
        # past the join: the local gradients may go before the update
        self.leaf_vals = self.out_buckets = self.acc = None
        return out

    def new_agg(self) -> tuple:
        return tuple(self.new_states) if self.states else self.states


# --------------------------------------------------------------------------
# the segmented backward
# --------------------------------------------------------------------------
def _backward_seed(setup, loss_sum: torch.Tensor, ntok: torch.Tensor):
    """(d(scaled loss)/d(loss sum), global token count): the classic
    step's loss scale ``p_dp / n_global``, in the loss's dtype."""
    n_glob = cp.psum(ntok, setup.dp_axes)
    return (setup.p_dp / n_glob.float()).to(loss_sum.dtype), n_glob


def _leaf(t: torch.Tensor) -> torch.Tensor:
    """A detached view of ``t`` that autograd differentiates on its own."""
    return t.detach().requires_grad_()


def _backward_stack(setup, ov: OverlapLayout, batch: dict, flush: _Flush,
                    xent_chunk: int):
    """The single-stack families: the forward keeps one autograd graph
    per stage; the backward takes them in reverse layer order, handing
    each stage's leaf gradients to ``flush``.  The hybrid family's groups
    also read the shared block, whose leaves enter every group's graph:
    each group's backward differentiates them too, and their gradient is
    the sum over the groups in reverse group order (JAX's
    ``has_shared``), part of the tail.  Returns (ordered aggregated
    leaves, loss sum, global token count, MoE loss)."""
    from repro_torch.models.model import SHARED_PREFIX
    from repro_torch.train.train_step import MOE_AUX_COEF

    model = setup.model
    seg = ov.stacks[0]
    stacked = [(name, p.detach()) for name, p in model.block_params()]
    leaves = {name: _leaf(p) for name, p in model.named_parameters()
              if not name.startswith(model.stack_prefix)}  # the tail
    shared = {name[len(SHARED_PREFIX):]: t for name, t in leaves.items()
              if name.startswith(SHARED_PREFIX)}
    head = ("final_norm.scale", "embed.table" if model.cfg.tie_embeddings
            else "unembed.table")
    labels = batch["labels"]
    mrope = model.mrope_positions(batch)

    # ---- forward: one graph per stage --------------------------------
    with torch.enable_grad():
        x0 = model.stage_embeds(batch["embeds"]) if "embeds" in batch \
            else model.stage_embed(leaves["embed.table"], batch["tokens"])
        positions = positions_of(labels)
        x = _leaf(x0)
        stages = []
        for layer in range(seg.n_layers):
            p_l = {name: p[layer].requires_grad_() for name, p in stacked}
            y = model.stage_block(p_l, x, positions, shared,
                                  mrope_positions=mrope)
            # the block's outputs: (y,) or, for MoE, (y, its aux loss)
            outs = y if model.has_aux else (y,)
            stages.append((p_l, x, outs))
            x = _leaf(outs[0])
        loss_sum, ntok = model.stage_loss(*(leaves[n] for n in head), x,
                                          labels, xent_chunk)
    seed, n_glob = _backward_seed(setup, loss_sum, ntok)
    L = seg.n_layers
    if model.has_aux:
        moe_aux = sum(outs[1].detach() for _, _, outs in stages) / L
        # a fill on the device, not a copy from the host
        aux_seed = (moe_aux.new_full((), MOE_AUX_COEF / (L * setup.aux_div)),)
    else:
        moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        aux_seed = ()

    # ---- backward: reverse layer order, flushing completed buckets ----
    *d_head, d_x = torch.autograd.grad(
        loss_sum, (*(leaves[n] for n in head), x), seed)
    grads = dict(zip(head, d_head))
    del x
    n_p, d_shared = len(stacked), None
    for s in range(L):
        p_l, x_in, outs = stages[L - 1 - s]
        stages[L - 1 - s] = None                  # free the stage's graph
        d = torch.autograd.grad(outs, (*p_l.values(), *shared.values(),
                                       x_in), (d_x, *aux_seed))
        del p_l, x_in, outs
        d_p, d_sh, d_x = d[:n_p], d[n_p:-1], d[-1]
        if shared:
            d_shared = d_sh if d_shared is None else [
                a + b for a, b in zip(d_shared, d_sh)]
        flush.stage(seg.stage0 + s, d_p)
    if shared:
        grads.update(zip((SHARED_PREFIX + n for n in shared), d_shared))
    if x0.requires_grad:
        d_emb, = torch.autograd.grad(x0, leaves["embed.table"], d_x)
    else:               # embeds in place of the lookup: no gradient
        d_emb = torch.zeros_like(leaves["embed.table"])
    del d_x, x0
    grads["embed.table"] = grads["embed.table"] + d_emb \
        if "embed.table" in grads else d_emb
    return (flush.tail([grads[n] for n in leaves]), loss_sum.detach(),
            n_glob, moe_aux)


def _backward_encdec(setup, ov: OverlapLayout, batch: dict, flush: _Flush,
                     xent_chunk: int):
    """The audio family: the forward keeps one autograd graph per encoder
    block, one for ``enc_norm`` (the memory), one for the decoder's
    embedding and one per decoder block, whose memory input is a
    detached leaf of its own.  The backward takes the decoder blocks in
    reverse, summing the memory's gradient over their cross-attentions,
    then ``enc_norm``, then the encoder blocks in reverse (stages
    ``L_dec..``), handing each stage's leaf gradients to ``flush``; the
    tail sums the loss head's, the decoder embedding's and ``enc_norm``'s
    gradients.  At ``tp > 1`` the memory's graph ends in
    ``stage_memory``'s ``tp_copy``, so the summed gradient crosses
    ``model`` once, after the decoder, as in the JAX package's scan.
    Returns what ``_backward_stack`` returns."""
    from repro_torch.models.model import DEC_PREFIX, ENC_PREFIX

    model = setup.model
    dec_seg, enc_seg = ov.stacks
    stacked = {pre: [(name, p.detach()) for name, p in
                     model.block_params(pre)]
               for pre in (DEC_PREFIX, ENC_PREFIX)}
    leaves = {name: _leaf(p) for name, p in model.named_parameters()
              if not name.startswith((DEC_PREFIX, ENC_PREFIX))}  # the tail
    head = ("final_norm.scale", "embed.table" if model.cfg.tie_embeddings
            else "unembed.table")
    tokens, labels = batch["tokens"], batch["labels"]

    def run(pre: str, n: int, x: torch.Tensor, positions: torch.Tensor,
            memory: Optional[torch.Tensor] = None):
        """One graph per block of the stack under ``pre``: [(its
        parameter slices, its input, its output)] and the last output."""
        stages = []
        for layer in range(n):
            p_l = {name: p[layer].requires_grad_()
                   for name, p in stacked[pre]}
            y = model.stage_block(p_l, x, positions, memory=memory)
            stages.append((p_l, x, y))
            x = _leaf(y)
        return stages, x

    # ---- forward: one graph per stage --------------------------------
    with torch.enable_grad():
        # the frame embeddings are an input, not a parameter: no gradient
        # reaches them, nor the first encoder block's input
        x = model.stage_encoder_in(batch["enc_embeds"])
        enc_stages, x_e = run(ENC_PREFIX, enc_seg.n_layers, x,
                              positions_of(batch["enc_embeds"][..., 0]))
        memory = model.stage_memory(leaves["enc_norm.scale"], x_e)
        mem = _leaf(memory)
        x0 = model.stage_embed(leaves["embed.table"], tokens)
        dec_stages, x = run(DEC_PREFIX, dec_seg.n_layers, _leaf(x0),
                            positions_of(tokens), mem)
        loss_sum, ntok = model.stage_loss(*(leaves[n] for n in head), x,
                                          labels, xent_chunk)
    seed, n_glob = _backward_seed(setup, loss_sum, ntok)

    # ---- backward: the decoder in reverse, then enc_norm, then the
    # ---- encoder in reverse, flushing completed buckets ----------------
    *d_head, d_x = torch.autograd.grad(
        loss_sum, (*(leaves[n] for n in head), x), seed)
    grads = dict(zip(head, d_head))
    del x
    d_mem = None
    for s in range(dec_seg.n_layers):
        p_l, x_in, y = dec_stages.pop()           # frees the stage's graph
        *d_p, d_x, d_m = torch.autograd.grad(y, (*p_l.values(), x_in, mem),
                                             d_x)
        del p_l, x_in, y
        d_mem = d_m if d_mem is None else d_mem + d_m
        flush.stage(dec_seg.stage0 + s, d_p)
    d_emb, = torch.autograd.grad(x0, leaves["embed.table"], d_x)
    del d_x, x0, mem
    grads["enc_norm.scale"], d_x = torch.autograd.grad(
        memory, (leaves["enc_norm.scale"], x_e), d_mem)
    del d_mem, memory, x_e
    for s in range(enc_seg.n_layers):
        p_l, x_in, y = enc_stages.pop()
        wrt = (*p_l.values(), x_in) if x_in.requires_grad \
            else tuple(p_l.values())
        d = torch.autograd.grad(y, wrt, d_x)
        del y
        flush.stage(enc_seg.stage0 + s, d[:len(p_l)])
        d_x = d[-1] if x_in.requires_grad else None
        del p_l, x_in, d
    grads["embed.table"] = grads["embed.table"] + d_emb \
        if "embed.table" in grads else d_emb
    aux = torch.zeros((), dtype=torch.float32, device=loss_sum.device)
    return (flush.tail([grads[n] for n in leaves]), loss_sum.detach(),
            n_glob, aux)


def _segmented_backward(setup, ov: OverlapLayout, batch: dict,
                        flush: _Flush, xent_chunk: int):
    """Forward (one graph per stage) and reverse-order backward with
    per-bucket aggregation through ``flush``; returns (ordered leaves,
    loss sum, global token count, MoE loss).  ``flush.schedule``
    ``"overlap"`` flushes each completed bucket between backward stages;
    ``"serial"`` flushes every bucket after the whole backward (the same
    bits); ``"raw"`` aggregates nothing and returns the local
    gradients."""
    if setup.model.cfg.family == "audio":
        return _backward_encdec(setup, ov, batch, flush, xent_chunk)
    return _backward_stack(setup, ov, batch, flush, xent_chunk)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------
def make_step(setup, schedule: str = "overlap", accum: int = 1,
              xent_chunk: int = 1024):
    """The segmented-backward step: ``step(state, batch, lr) -> (state,
    metrics)``, the contract of ``train_step.make_step``.

    ``schedule="overlap"`` degrades to ``"serial"`` or ``"raw"`` where the
    comm plan does not pipeline (``effective_schedule``).  ``accum > 1``
    splits the batch into microbatches whose gradients are summed in fp32
    in ordered-leaf form; each bucket is flushed once, on the final
    microbatch, as ``(g + sum) * (1 / accum)``.  ``setup.zero1`` routes the
    update through ``train_step.zero1_apply``.  After each call
    ``step.flush_order`` lists (bucket, stage after which it was issued)
    in order of issue."""
    from repro_torch.train import train_step as ts

    if schedule not in ("overlap", "serial"):
        raise ValueError(f"schedule={schedule!r}")
    if accum < 1:
        raise ValueError(f"accum={accum}")
    check_supported(setup.arch, setup.arch.plan)
    ov = build_layout(setup)
    if schedule == "overlap":
        schedule = effective_schedule(setup)
    if setup.rtob:
        # no per-bucket gradient collective to schedule: the update's
        # owner-aligned reduce-scatter is the only gradient exchange
        schedule = "raw"
    update_fn = ts.make_update_fn(setup, ov.layout, ov)
    aggregator = agg_mod.GradAggregator(setup.agg_cfg)
    do_agg = bool(setup.agg_cfg.compress_axes or setup.agg_cfg.raw_axes)
    side = torch.cuda.Stream(setup.device) \
        if setup.device.type == "cuda" else None

    def backward(batch, agg_states):
        if accum == 1:
            flush = _Flush(ov, aggregator, agg_states, schedule, do_agg,
                           side)
            leaves, loss_sum, n_glob, aux = _segmented_backward(
                setup, ov, batch, flush, xent_chunk)
            return leaves, flush, loss_sum, n_glob, aux
        micro = ts.microbatches(batch, accum)
        acc = loss_sum = n_glob = aux = None
        for m in micro[:-1]:
            raw = _Flush(ov, aggregator, (), "raw", False)
            g, l_m, n_m, a_m = _segmented_backward(setup, ov, m, raw,
                                                   xent_chunk)
            with torch.no_grad():
                if acc is None:       # the fp32 sum starts at zero: exact
                    acc = [v.float() for v in g]
                else:
                    for a, v in zip(acc, g):
                        a.add_(v)
            del g, raw
            loss_sum = l_m if loss_sum is None else loss_sum + l_m
            n_glob = n_m if n_glob is None else n_glob + n_m
            aux = a_m if aux is None else aux + a_m
        flush = _Flush(ov, aggregator, agg_states, schedule, do_agg, side,
                       acc=acc, inv_accum=1.0 / accum)
        del acc
        leaves, l_m, n_m, a_m = _segmented_backward(
            setup, ov, micro[-1], flush, xent_chunk)
        return (leaves, flush, loss_sum + l_m, n_glob + n_m,
                (aux + a_m) / accum)

    flush_order: list = []

    def step(state: dict, batch: dict, lr: float):
        batch = ts._to_device(batch, setup.device)
        leaves, flush, loss_sum, n_glob, aux = backward(batch, state["agg"])
        with torch.no_grad():
            params, new_opt, gnorm = update_fn(state["params"], leaves,
                                               state["opt"], lr)
            del leaves
            metrics = ts.train_metrics(setup, loss_sum, n_glob, gnorm, aux)
        flush_order[:] = flush.order
        return {"step": state["step"] + 1, "params": params, "opt": new_opt,
                "agg": flush.new_agg()}, metrics

    # a list the step refills, not a reference to the step itself: a
    # function that points at itself lives until the garbage collector
    # runs, and with it the model it closes over
    step.flush_order = flush_order
    return step


# --------------------------------------------------------------------------
# the no-overlap strawman: the whole backward, then every bucket
# --------------------------------------------------------------------------
def make_unfused_step(setup, xent_chunk: int = 1024):
    """The paper-Fig-2 strawman: a raw segmented backward materializes the
    local gradients; then every bucket is aggregated on the compute
    stream (``aggregate_bucket_list`` over the ordered leaves), then the
    update.  Nothing overlaps.  Same contract as :func:`make_step`."""
    from repro_torch.train import train_step as ts

    check_supported(setup.arch, setup.arch.plan)
    ov = build_layout(setup)
    update_fn = ts.make_update_fn(setup, ov.layout, ov)
    aggregator = agg_mod.GradAggregator(setup.agg_cfg)
    do_agg = not setup.rtob and bool(setup.agg_cfg.compress_axes
                                     or setup.agg_cfg.raw_axes)

    def step(state: dict, batch: dict, lr: float):
        batch = ts._to_device(batch, setup.device)
        flush = _Flush(ov, aggregator, (), "raw", False)
        leaves, loss_sum, n_glob, aux = _segmented_backward(
            setup, ov, batch, flush, xent_chunk)
        new_agg = state["agg"]
        with torch.no_grad():
            if do_agg:
                buckets = bucketing.leaves_to_buckets(leaves, ov.layout)
                outs, news = aggregator.aggregate_bucket_list(buckets,
                                                              state["agg"])
                del buckets
                leaves = bucketing.buckets_to_leaves(outs, leaves, ov.layout)
                del outs
                if state["agg"]:
                    new_agg = news
            params, new_opt, gnorm = update_fn(state["params"], leaves,
                                               state["opt"], lr)
            del leaves
            metrics = ts.train_metrics(setup, loss_sum, n_glob, gnorm, aux)
        return {"step": state["step"] + 1, "params": params, "opt": new_opt,
                "agg": new_agg}, metrics

    return step


# --------------------------------------------------------------------------
# leaf order
# --------------------------------------------------------------------------
def _ordered_index(ov: OverlapLayout) -> list[int]:
    """Per ordered leaf (:func:`_ordered_leaves`), the position in
    parameter order of the parameter it is a view of."""
    out = []
    for seg, at in zip(ov.stacks, ov.stack_params):
        for _ in range(seg.n_layers):
            out.extend(at)
    return out + list(ov.rest)


def _ordered_leaves(ov: OverlapLayout, leaves: Sequence[torch.Tensor]
                    ) -> list[torch.Tensor]:
    """Leaves in parameter order -> the backward-completion order
    :func:`build_layout` built the bucket layout over: per-layer views
    ``t[l]`` of the stack's ``(L, ...)`` leaves, last layer first, then
    the tail."""
    out = []
    for seg, at in zip(ov.stacks, ov.stack_params):
        stack = [leaves[i] for i in at]
        for s in range(seg.n_layers):
            out.extend(t[seg.n_layers - 1 - s] for t in stack)
    out.extend(leaves[i] for i in ov.rest)
    return out


def _unordered_tree(ov: OverlapLayout, ordered: Sequence[torch.Tensor]
                    ) -> list[torch.Tensor]:
    """Inverse of :func:`_ordered_leaves`: the per-layer leaves stacked
    back into ``(L, ...)`` leaves, in parameter order."""
    out: list = [None] * (sum(map(len, ov.stack_params)) + len(ov.rest))
    for seg, pos in zip(ov.stacks, ov.stack_params):
        nb, L = seg.n_leaves, seg.n_layers
        for i, at in enumerate(pos):
            out[at] = torch.stack([ordered[seg.leaf0 + (L - 1 - l) * nb + i]
                                   for l in range(L)])
    for j, at in enumerate(ov.rest):
        out[at] = ordered[ov.stacks[-1].leaf_end + j]
    return out
