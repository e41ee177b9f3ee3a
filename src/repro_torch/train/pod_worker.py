"""One rank of a measured two-tier pod.  Counterpart of
``repro.train.pod_worker``.

Run under ``torchrun`` with ``--procs x --local-devices`` processes (one
torch process per rank: the JAX package's process of ``--local-devices``
devices is here ``--local-devices`` processes).  The ranks join the
``pod x data`` mesh of ``launch.mesh.init_pod_mesh``: ``pod`` spans the
pods over gloo, the measured slow tier; ``data`` spans each pod's ranks
(NCCL when each rank has a card of its own, else gloo).  The unchanged
train/overlap/CommPlan machinery then runs on that mesh, so
``--comm hierarchical:data`` is a real two-stage reduction.

Measured per cell (round robin, min of reps: ``overlap_bench``'s
protocol, ``timed_interleaved``):

  * ``t_serial_us`` / ``t_overlap_us``: the serial and overlapped DDP
    schedules on the pod mesh, each with its own setup;
  * ``t_compute_us``: the same per-rank workload (this rank's rows) on a
    one-rank setup with ``compression="none"``, ``zero1=False`` and no
    collective, run after the pod setups are freed: the compute offset a
    calibration subtracts.  Every rank runs it at once, as in the pod
    phase, so ranks that share a card share it here too.

Checked and recorded: every loss; a digest of the parameters on every
rank (all equal: ``params_identical``); ``serial`` against ``overlap``
bit for bit on every rank (parameters, optimizer state, compressor
state, losses: ``serial_equals_overlap``); the mean of one
bucket of this rank's fp32 gradient under each comm plan over
``("pod", "data")`` against ``allreduce`` (``plan_check``); the kernel
launches of the timed steps; each axis's collective backend; the peak
device memory of every rank.

FSDP (``--plan dp_mode=fsdp``, with ``fsdp_shard_pods`` and ``gather_quant`` as
further ``--plan`` fields): the classic FSDP step (``train_step.make_step``;
there is no overlapped FSDP step) on the same mesh, ``--warmup + --reps`` steps
on this rank's rows of step 0's global batch (``batch_at``, split over the DP
ranks: the same global batch at any mesh), each timed on its own (``step_s``).
``--variant LABEL:FIELD=VALUE,...`` (repeatable) runs each plan variant in turn
in the same processes (one start, one set of gloo connections), ``steps=N`` its
step count; the record is then ``{"variants": [one record each]}``. HSDP shards
the parameters over ``data`` and runs the compressor over ``pod`` on gradient
shards; ``fsdp_shard_pods`` shards over both axes. For a vlm or audio arch the
stubbed frontends' inputs (fp32 ``embeds`` and the ``vlm_positions``, or fp32
``enc_embeds``) are drawn once for that global batch from seed 0
(``launch.inputs.with_frontend_inputs``) and split with it, so a TP cell reads
the one-rank reference's batch. Checked and recorded: every loss; the ranks
with the same index along the FSDP axes (one per pod under HSDP) hold the same
shard bits (``replicas_identical``); every sharded parameter gathered over the
FSDP axes has the same bits on every rank (``gathered_identical``); whether the
leaves FSDP does not shard have the same bits on every rank
(``unsharded_identical``: they do when nothing is compressed; under HSDP with a
compressor they ride buckets of each ``data`` rank's own shards through the
lossy exchange and drift apart across ``data``, in the JAX package too); the
kernel launches; each rank's peak device memory and the card's memory in use
after the steps (``card_used_gb``, from ``torch.cuda.mem_get_info``).

Tensor parallelism (``--tp N``, the counterpart of ``make_pod_mesh(...,
tp=N)``): the mesh is ``pod x data x model`` with ``model`` innermost, so
the world has ``procs x local-devices x tp`` ranks, and each rank reads
the rows of its DP coordinate.  With ``--tp`` or ``--variant`` the
variant runs of the FSDP cell serve the DDP step too (classic, or
overlapped under ``overlap=true``; ``serial=true`` also runs the serial
schedule from the same seed and batches and records whether every
rank's parameters, optimizer and compressor state and losses have the
same bits as the overlapped run's: ``serial_equals_overlap``).  A
variant may name its own ``arch=`` and ``layers=``.  Checked and recorded
beside the FSDP fields: ``tp`` and the mesh's axes; whether the ranks
with the same model index hold the same bits, gathered over the FSDP
axes (``dp_replicas_identical``); whether the leaves replicated over
``model`` hold the same bits on every rank (``model_replicated_identical``);
the bucket sizes the compressor saw.

Resume (a variant's ``ckpt=true``, with ``--ckpt-dir``): the variant's
steps run once, uninterrupted, with a checkpoint of step 1 saved in
``<ckpt-dir>/<label>`` (``checkpoint.manager.CheckpointManager``: the
FSDP and TP leaves written slice by slice into the JAX package's global
layout, the per-rank leaves stacked); then a fresh setup restores it and takes the
steps after it.  Recorded: ``resume_identical`` (its losses and every
rank's state fingerprints after the last step are the uninterrupted
run's, bit for bit), ``ckpt_bytes`` (the step's files), ``save_s`` and
``restore_s`` (the slowest rank's), ``ckpt_prints`` (the fingerprints of
the saved global parameters, gathered on the card), ``ckpt_loss_fp32``
(the saved state's loss on the batch with fp32 compute: a reader at
another layout can match it without the bf16 rounding of the partial
sums over ``model``), each rank's host peak (``host_peak_gb``, the
process's maximum resident set) and ``ckpt_path``.

Every rank runs the same program; rank 0's last stdout line is the JSON
record, the other ranks keep stdout silent (logs go to stderr).  The
default arch is the reduced one, as in the JAX package;
``--full-width --layers N`` gives the arch's widths at depth N::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.train.pod_worker \\
        --procs 2 --local-devices 2 --json
    torchrun --standalone --nproc-per-node 4 -m repro_torch.train.pod_worker \\
        --procs 2 --local-devices 2 --arch qwen2-vl-7b --plan dp_mode=fsdp \\
        --method powersgd --json
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import time

#: one bucket's prefix that ``plan_check`` reduces under every plan
PLAN_CHECK_ELEMS = 1 << 21
PLAN_CHECK_KINDS = ("allreduce", "reduce_scatter_allgather", "gather_all",
                    "hierarchical")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--procs", type=int, required=True,
                    help="pods (the 'pod' axis)")
    ap.add_argument("--proc-id", type=int, default=None,
                    help="without torchrun: this process's rank")
    ap.add_argument("--coordinator", default="127.0.0.1:12355",
                    help="without torchrun: host:port that rank 0 binds")
    ap.add_argument("--local-devices", type=int, default=2,
                    help="ranks per pod (the 'data' axis)")
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks per model group (the 'model' axis, "
                         "innermost)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full-width", action="store_true",
                    help="the arch's widths (default: the reduced config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the config's)")
    ap.add_argument("--method", default="none")
    ap.add_argument("--plan", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="extra ParallelPlan override (repeatable)")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--comm", default="auto",
                    help="CommPlan kind; 'hierarchical:data' = the ring "
                         "inside each pod, then across pods: the two-tier "
                         "schedule this mesh exists to measure")
    ap.add_argument("--batch", type=int, default=8,
                    help="GLOBAL batch (split over procs x local devices)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--bucket-mb", type=float, default=1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="LABEL:FIELD=VALUE[,FIELD=VALUE...]",
                    help="FSDP: run this plan variant after the others in "
                         "the same processes (repeatable); 'steps=N' sets "
                         "its step count")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where a variant with ckpt=true saves its "
                         "checkpoint of step 1 (a directory per variant)")
    ap.add_argument("--json", action="store_true",
                    help="rank 0 prints the JSON record as its last stdout "
                         "line")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs import base
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.experiments.backend import coerce_kv
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import overlap
    from repro_torch.train import train_step as ts
    from repro_torch.train.overlap_bench import timed_interleaved

    t_start = time.perf_counter()
    world = args.procs * args.local_devices * args.tp
    if args.proc_id is not None:
        mesh_mod.set_rank_env(args.proc_id, world, args.coordinator)
    dev = mesh_mod.local_device(args.device)
    cuda = dev.type == "cuda"
    mesh_mod.init_world(dev)
    try:
        mesh_mod.init_pod_mesh(args.procs, args.local_devices, dev,
                               tp=args.tp)
        rank = dist.get_rank()
        p_dp = args.procs * args.local_devices
        dp_rank = mesh_mod.rank(("pod", "data"))

        def log(msg: str) -> None:
            print(f"[pod_worker {rank}] {msg}", file=sys.stderr, flush=True)

        plan_overrides = {}
        for kv in args.plan:
            k, _, v = kv.partition("=")
            plan_overrides[k] = coerce_kv(v)
        cfg = base.get(args.arch)
        if not args.full_width:
            cfg = base.reduced(cfg)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        plan_fields = dict(dp_mode="ddp", zero1=args.zero1, overlap=True,
                           compression=args.method, bucket_mb=args.bucket_mb,
                           comm=args.comm)
        if args.tp > 1:
            # the variants name the schedule; the classic step by default
            plan_fields["overlap"] = False
        plan_fields.update(plan_overrides)
        if plan_fields["dp_mode"] == "fsdp":
            plan_fields["overlap"] = False     # no overlapped FSDP step
        cfg = dataclasses.replace(cfg, plan=dataclasses.replace(
            cfg.plan, **plan_fields))
        backends = mesh_mod.backends()
        log(f"mesh {mesh_mod.axis_sizes()} (p_dp={p_dp}) on {dev}, "
            f"backends {backends}")
        if cfg.plan.dp_mode == "fsdp" or args.variant or args.tp > 1:
            variants = [_variant(v, args.warmup + args.reps)
                        for v in args.variant] \
                or [("fsdp", {}, args.warmup + args.reps)]
            recs = []
            for label, fields, n_steps in variants:
                vcfg = cfg
                named = dict(fields)
                name, layers = fields.pop("arch", None), \
                    fields.pop("layers", None)
                serial = bool(fields.pop("serial", False))
                ckpt = bool(fields.pop("ckpt", False))
                if ckpt and not args.ckpt_dir:
                    raise SystemExit(f"variant {label!r}: ckpt=true needs "
                                     f"--ckpt-dir")
                if name:
                    vcfg = base.get(name)
                    if not args.full_width:
                        vcfg = base.reduced(vcfg)
                    vcfg = dataclasses.replace(vcfg, plan=dataclasses.replace(
                        vcfg.plan, **plan_fields))
                if layers:
                    vcfg = dataclasses.replace(vcfg, n_layers=int(layers))
                plan = dataclasses.replace(vcfg.plan, **fields)
                if plan.dp_mode == "fsdp":
                    plan = dataclasses.replace(plan, overlap=False)
                rec = _variant_run(
                    args, dataclasses.replace(vcfg, plan=plan), dev, log,
                    t_start, n_steps, serial,
                    os.path.join(args.ckpt_dir, label.replace(" ", "_"))
                    if ckpt else None)
                # what the variant named: plan fields, arch, layers, serial
                rec.update(label=label, plan_overrides={
                    **plan_overrides, **named} or None,
                    backends=backends)
                recs.append(rec)
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
            out = recs[0] if not args.variant else dict(
                variants=recs, wall_s=time.perf_counter() - t_start)
            if args.json and rank == 0:
                print(json.dumps(out), flush=True)
            return out

        names = ("serial", "overlap")
        setups = {k: ts.build(cfg, dev) for k in names}
        setup = setups["overlap"]
        ov = overlap.build_layout(setup)
        grad_bytes = ov.layout.n_elements \
            * torch.empty((), dtype=ov.layout.dtype).element_size()
        batch = next(Pipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                         global_batch=args.batch),
                              host=dp_rank, num_hosts=p_dp, prefetch=0))
        steps = {k: overlap.make_step(setups[k], k, accum=args.accum)
                 for k in names}
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        kbuild.reset_launches()
        runs: dict = {}
        t = timed_interleaved(setups, steps, batch, args.reps, args.warmup,
                              out=runs)
        launches = dict(kbuild.LAUNCHES)
        t_serial, t_overlap = t["serial"], t["overlap"]
        log(f"pod: serial={t_serial * 1e6:.1f}us "
            f"overlap={t_overlap * 1e6:.1f}us")

        same = _same_bits([runs[k]["state"] for k in names]) \
            and runs["serial"]["losses"] == runs["overlap"]["losses"]
        params = ts.state_digest(list(setup.model.parameters()))
        plan_check = _plan_check(setups["serial"], ov, batch)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
        everyone = [None] * world
        dist.all_gather_object(everyone, dict(params=params, same=same,
                                              peak=peak))
        losses = {k: runs[k]["losses"] for k in names}
        shape = dict(
            n_buckets=ov.layout.n_buckets,
            effective_schedule=overlap.effective_schedule(setup),
            compress_axes=list(setup.agg_cfg.compress_axes),
            raw_axes=list(setup.agg_cfg.raw_axes))
        del setups, steps, runs, setup
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # ---- the compute offset: this rank's workload on one rank, no
        # ---- collective (no DP axis, nothing aggregated)
        cfg_local = dataclasses.replace(cfg, plan=dataclasses.replace(
            cfg.plan, compression="none", comm="auto", zero1=False))
        local = ts.build(cfg_local, dev)
        local.dp_axes = ()
        local.agg_cfg = dataclasses.replace(local.agg_cfg, compress_axes=(),
                                            raw_axes=())
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t_compute = timed_interleaved(
            {"serial": local}, {"serial": overlap.make_step(local, "serial")},
            batch, args.reps, args.warmup)["serial"]
        peak_compute = torch.cuda.max_memory_allocated(dev) / 2**30 \
            if cuda else None
        log(f"local compute (1 rank, batch {batch['tokens'].shape[0]}): "
            f"{t_compute * 1e6:.1f}us")
        del local
        gc.collect()

        n_steps = len(names) * (args.warmup + args.reps)
        rec = dict(
            arch=cfg.name, n_layers=cfg.n_layers, method=args.method,
            workers=world, procs=args.procs,
            local_devices=args.local_devices, zero1=args.zero1,
            accum=args.accum, comm=args.comm,
            plan_overrides=plan_overrides or None, **shape,
            **_mesh_desc(args),
            grad_bytes=grad_bytes, batch=args.batch, seq=args.seq,
            reps=args.reps, warmup=args.warmup,
            t_serial_us=t_serial * 1e6, t_overlap_us=t_overlap * 1e6,
            t_compute_us=t_compute * 1e6,
            overlap_vs_serial=t_overlap / t_serial,
            fig2_saving_pct=(1 - t_overlap / t_serial) * 100,
            backends=backends,
            device=torch.cuda.get_device_name(dev) if cuda else "cpu",
            peak_mem_gb=[e["peak"] for e in everyone],
            peak_mem_gb_compute=peak_compute,
            losses=losses,
            params_identical=all(e["params"] == everyone[0]["params"]
                                 for e in everyone),
            serial_equals_overlap=all(e["same"] for e in everyone),
            plan_check=plan_check,
            steps_timed=n_steps, launches=launches,
            wall_s=time.perf_counter() - t_start)
        log(f"OK: params identical {rec['params_identical']}, serial == "
            f"overlap {rec['serial_equals_overlap']}, launches {launches}")
        if args.json and rank == 0:
            print(json.dumps(rec), flush=True)
        return rec
    finally:
        dist.destroy_process_group()


#: odd 64-bit multipliers (splitmix64's), as the signed int64 they wrap to
_MIX = tuple(k - (1 << 64) if k >= 1 << 63 else k
             for k in (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                       0x94D049BB133111EB))


def _shr(x, n: int):
    """The logical right shift of an int64 tensor."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def fingerprint(t) -> tuple[int, int]:
    """Two wrapping int64 sums over ``t``'s bit patterns, taken on its
    device a chunk at a time: the plain sum, and the sum of a 64-bit
    mix (splitmix64's finalizer) of each pattern with its position.
    Equal bits give equal fingerprints; another value, or two values
    swapped, changes the second sum except with odds near 2^-64."""
    import torch
    flat = t.detach().reshape(-1)
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[flat.element_size()]
    bits = flat.view(view)
    s1 = torch.zeros((), dtype=torch.int64, device=t.device)
    s2 = torch.zeros((), dtype=torch.int64, device=t.device)
    chunk = 1 << 24
    for a in range(0, bits.numel(), chunk):
        b = bits[a:a + chunk].long()
        x = b + (torch.arange(a, a + b.numel(), device=t.device) + 1) \
            * _MIX[0]
        x = (x ^ _shr(x, 30)) * _MIX[1]
        x = (x ^ _shr(x, 27)) * _MIX[2]
        s1 += b.sum()
        s2 += (x ^ _shr(x, 31)).sum()
    return int(s1.item()), int(s2.item())


def _variant(spec: str, default_steps: int) -> tuple[str, dict, int]:
    """``"LABEL:FIELD=VALUE,..."`` -> (label, plan fields, steps)."""
    from repro_torch.experiments.backend import coerce_kv
    label, _, rest = spec.partition(":")
    fields = {}
    for kv in filter(None, rest.split(",")):
        k, _, v = kv.partition("=")
        fields[k] = coerce_kv(v)
    return label, fields, int(fields.pop("steps", default_steps))


def _mesh_desc(args) -> dict:
    """The record's ``mesh_axes`` and ``mesh_shape`` (``model`` only when
    it has more than one rank)."""
    axes, shape = ["pod", "data"], [args.procs, args.local_devices]
    if args.tp > 1:
        axes.append("model")
        shape.append(args.tp)
    return dict(mesh_axes=axes, mesh_shape=shape)


def _run_steps(setup, make, batch, n_steps: int, cuda: bool, dev,
               state=None, after_first=None):
    """``n_steps`` steps of ``make(setup)`` from ``state`` (default
    ``init_state(seed=0)``) on ``batch``, each timed on its own;
    ``after_first(state)`` runs after the first step, outside its time.
    Returns (state, losses, step seconds)."""
    import torch

    from repro_torch.train import train_step as ts
    if state is None:
        state = ts.init_state(setup, seed=0)
    step = make(setup)
    losses, step_s = [], []
    for i in range(n_steps):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch, 1e-4)
        if cuda:
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        if i == 0 and after_first is not None:
            after_first(state)
    return state, losses, step_s


def _timed(fn, cuda: bool, dev) -> float:
    """Seconds of ``fn()``, the device synchronised at both ends."""
    import torch
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def forward_loss(setup, batch: dict, dtype) -> float:
    """The DP-global loss of one forward pass of ``setup``'s model on this
    rank's ``batch``, computing in ``dtype`` (every rank calls it)."""
    import torch

    from repro_torch.parallel import commplan as cp
    from repro_torch.train import train_step as ts
    model = setup.model
    ctx = model.ctx
    model.ctx = dataclasses.replace(ctx, compute_dtype=dtype)
    try:
        with torch.no_grad():
            loss_sum, ntok, _ = model.loss(ts._to_device(batch, setup.device))
    finally:
        model.ctx = ctx
    if setup.dp_axes:
        loss_sum = cp.psum(loss_sum, setup.dp_axes)
        ntok = cp.psum(ntok, setup.dp_axes)
    return (loss_sum / ntok.float()).item()


def _global_prints(setup) -> list:
    """The fingerprints of every global parameter, each gathered on its
    device over the axes that shard it (every rank calls it)."""
    from repro_torch.checkpoint.manager import leaf_splits
    from repro_torch.convert import gather_global
    splits = leaf_splits(setup)
    out = []
    for name, p in setup.model.named_parameters():
        g = gather_global(p, splits[name])
        out.append(fingerprint(g))
        del g
    return out


def _resume(cfg, batch, n_steps: int, losses: list, prints: list,
            saved: dict, path: str, cuda: bool, dev, log) -> dict:
    """A fresh setup restores the checkpoint of step 1 at ``path`` and
    takes steps 2..``n_steps``; its losses and state fingerprints against
    the uninterrupted run's (``losses``, ``prints``).  Returns this
    rank's fields."""
    import resource

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train import train_step as ts
    fresh = ts.build(cfg, dev)
    got = {}

    def restore():
        got["state"], got["cursor"] = CheckpointManager(
            path, fresh).restore(1)
    restore_s = _timed(restore, cuda, dev)
    state, r_losses, _ = _run_steps(fresh, ts.make_step, batch,
                                    n_steps - 1, cuda, dev, got["state"])
    same = r_losses == losses[1:] and got["cursor"] == 1 and [
        fingerprint(t) for t in _state_tensors(state)] == prints
    del state, got, fresh
    gc.collect()
    step_dir = os.path.join(path, "step_000000001")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir))
    log(f"resume: restore {restore_s:.2f} s, losses {r_losses}, "
        f"identical {same}, {nbytes:,} bytes")
    return dict(same=same, restore_s=restore_s, save_s=saved["save_s"],
                resume_losses=r_losses, ckpt_bytes=nbytes,
                host_peak_gb=resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 2**20)


def _variant_run(args, cfg, dev, log, t_start, n_steps: int,
                 serial: bool = False, ckpt_path: "str | None" = None
                 ) -> dict:
    """One variant cell (FSDP, or under ``--tp`` the DDP step too):
    build, ``n_steps`` timed steps, the checks; with ``serial`` (an
    overlapped DDP plan) the serial schedule's run from the same seed
    and batch after it, compared bit for bit; with ``ckpt_path`` a
    checkpoint of step 1 saved there and the resume from it
    (``_resume``).  Returns the record (every rank)."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.inputs import with_frontend_inputs
    from repro_torch.models.layers import fsdp_dim
    from repro_torch.parallel.collectives import all_gather
    from repro_torch.train import overlap
    from repro_torch.train import train_step as ts

    cuda = dev.type == "cuda"
    rank, world = dist.get_rank(), dist.get_world_size()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup = ts.build(cfg, dev)
    model = setup.model
    n_params = sum(math.prod(model.global_shape(n))
                   for n, _ in model.named_parameters())
    # this rank's rows of the global batch of step 0 and of its frontend
    # inputs (drawn once, from seed 0), whatever the mesh
    dp_rank = mesh_mod.rank(setup.dp_axes)
    batch = ts.split_batch(with_frontend_inputs(cfg, batch_at(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch), 0), 0),
        setup.p_dp, dp_rank)
    log(f"{cfg.plan.dp_mode}: {n_params:,} parameters, tp {setup.tp} (sp "
        f"{model.ctx.seq_parallel}), fsdp_axes {setup.fsdp_axes} (p_fsdp "
        f"{setup.p_fsdp}), compress {setup.agg_cfg.compressor}@"
        f"{setup.agg_cfg.compress_axes}, {setup.layout.n_buckets} "
        f"buckets, zero1 {setup.zero1}, overlap {setup.overlap}, "
        f"gather_quant {model.ctx.gather_quant}")
    kbuild.reset_launches()
    saved: dict = {}

    def save(state):
        from repro_torch.checkpoint.manager import CheckpointManager
        saved["save_s"] = _timed(lambda: CheckpointManager(
            ckpt_path, setup).save(1, state, cursor=1), cuda, dev)
        saved["prints"] = _global_prints(setup)
        saved["loss_fp32"] = forward_loss(setup, batch, torch.float32)
    state, losses, step_s = _run_steps(
        setup, ts.make_step, batch, n_steps, cuda, dev,
        after_first=save if ckpt_path else None)
    launches = dict(kbuild.LAUNCHES)
    final_prints = [fingerprint(t) for t in _state_tensors(state)] \
        if ckpt_path else None
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    used = None
    if cuda:
        free, total = torch.cuda.mem_get_info(dev)
        used = (total - free) / 2**30
    same_serial = None
    if serial:
        prints = [fingerprint(t) for t in _state_tensors(state)]
        del state
        gc.collect()
        s_state, s_losses, _ = _run_steps(
            setup, lambda st: overlap.make_step(st, "serial"), batch,
            n_steps, cuda, dev)
        same_serial = s_losses == losses and prints == [
            fingerprint(t) for t in _state_tensors(s_state)]
        del s_state
    # the replicas: the ranks with the same index along the FSDP axes
    # (and the same model index)
    coords = mesh_mod.coords()
    key = tuple(coords[a] for a in (*setup.fsdp_axes, "model")
                if a in coords)
    local = [fingerprint(p) for p in model.parameters()]
    gathered, unsharded, full = [], [], []
    for name, p in model.named_parameters():
        dim = fsdp_dim(name)
        if dim is None or not setup.fsdp_axes:
            unsharded.append(fingerprint(p))
            full.append(fingerprint(p))
            continue
        g = all_gather(p.detach(), setup.fsdp_axes, dim % p.ndim)
        gathered.append(fingerprint(g))
        full.append(gathered[-1])
        del g
    rep = setup.model_replicated()
    resumed = None
    if ckpt_path:
        state = None
        gc.collect()
        resumed = _resume(cfg, batch, n_steps, losses, final_prints, saved,
                          ckpt_path, cuda, dev, log)
    everyone = [None] * world
    dist.all_gather_object(everyone, dict(resumed=resumed,
        key=key, model=coords.get("model", 0), local=local,
        gathered=gathered, unsharded=unsharded, full=full, peak=peak,
        used=used, serial=same_serial))
    by_key: dict = {}
    for e in everyone:
        by_key.setdefault(tuple(e["key"]), []).append(e["local"])
    replicas = all(all(x == v[0] for x in v) for v in by_key.values())
    by_model: dict = {}
    for e in everyone:
        by_model.setdefault(e["model"], []).append(e)

    def same_within_model(field):
        return all(all(e[field] == v[0][field] for e in v)
                   for v in by_model.values())
    return dict(
        arch=cfg.name, n_layers=cfg.n_layers, n_params=n_params,
        dp_mode=cfg.plan.dp_mode, zero1=setup.zero1,
        overlap=setup.overlap, method=cfg.plan.compression, workers=world,
        procs=args.procs, local_devices=args.local_devices, tp=setup.tp,
        seq_parallel=model.ctx.seq_parallel,
        fsdp_axes=list(setup.fsdp_axes), p_fsdp=setup.p_fsdp,
        fsdp_shard_pods=cfg.plan.fsdp_shard_pods,
        gather_quant=model.ctx.gather_quant,
        compress_axes=list(setup.agg_cfg.compress_axes),
        raw_axes=list(setup.agg_cfg.raw_axes),
        n_buckets=setup.layout.n_buckets,
        bucket_sizes=list(setup.layout.sizes),
        **_mesh_desc(args),
        batch=args.batch, seq=args.seq,
        losses=losses, step_s=step_s, steps_timed=len(step_s),
        launches=launches,
        device=torch.cuda.get_device_name(dev) if cuda else "cpu",
        peak_mem_gb=[e["peak"] for e in everyone],
        card_used_gb=max((e["used"] for e in everyone
                          if e["used"] is not None), default=None),
        replica_groups=len(by_key),
        replicas_identical=replicas,
        gathered_identical=same_within_model("gathered"),
        unsharded_identical=same_within_model("unsharded"),
        dp_replicas_identical=same_within_model("full"),
        model_replicated_identical=all(
            [f for f, r in zip(e["full"], rep) if r]
            == [f for f, r in zip(everyone[0]["full"], rep) if r]
            for e in everyone),
        model_replicated_leaves=sum(rep),
        serial_equals_overlap=None if same_serial is None
        else all(e["serial"] for e in everyone),
        **(_resume_fields(everyone, saved, ckpt_path) if ckpt_path else {}),
        wall_s=time.perf_counter() - t_start)


def _resume_fields(everyone: list, saved: dict, path: str) -> dict:
    """The record's resume fields from every rank's ``_resume``."""
    res = [e["resumed"] for e in everyone]
    return dict(
        resume_identical=all(r["same"] for r in res),
        resume_losses=res[0]["resume_losses"],
        ckpt_bytes=res[0]["ckpt_bytes"],
        save_s=max(r["save_s"] for r in res),
        restore_s=max(r["restore_s"] for r in res),
        host_peak_gb=[r["host_peak_gb"] for r in res],
        ckpt_prints=saved["prints"], ckpt_loss_fp32=saved["loss_fp32"],
        ckpt_path=path)


def _state_tensors(state) -> list:
    """Every tensor of a train state, in a fixed order."""
    import torch
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _state_tensors(state[k])]
    if isinstance(state, (list, tuple)):
        return [t for v in state for t in _state_tensors(v)]
    return []


def _same_bits(states) -> bool:
    """Do two states (dicts, lists and tuples of tensors and scalars) hold
    the same bits?  Tensors are compared on their device, as bytes."""
    import torch
    a, b = states
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape and bool(torch.equal(
                a.detach().reshape(-1).view(torch.uint8),
                b.detach().reshape(-1).view(torch.uint8)))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(_same_bits((a[k], b[k])) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) \
            and all(_same_bits(pair) for pair in zip(a, b))
    return a == b


def _plan_check(setup, ov, batch: dict) -> dict:
    """The mean over ``("pod", "data")`` of the first ``PLAN_CHECK_ELEMS``
    elements of this rank's fp32 gradient bucket 0 under every comm plan
    of ``PLAN_CHECK_KINDS`` (``hierarchical`` with ``intra=("data",)``),
    against ``allreduce``: each plan's largest difference, whether the
    two-shot ring gives its bits, and whether ``hierarchical`` and
    ``gather_all`` are within ``rtol=1e-6, atol=1e-7`` (the JAX package's
    contract: fp-close, another summation order)."""
    import torch

    from repro_torch.parallel import commplan as cp
    from repro_torch.train import overlap
    from repro_torch.train import train_step as ts

    flush = overlap._Flush(ov, None, (), "raw", False)
    leaves, _, _, _ = overlap._segmented_backward(
        setup, ov, ts._to_device(batch, setup.device), flush, 1024)
    lo, hi = ov.layout.bucket_leaves(0)
    g = torch.cat([v.reshape(-1).float() for v in leaves[lo:hi]])
    g = g[:PLAN_CHECK_ELEMS].contiguous()
    del leaves
    axes = ("pod", "data")
    means = {k: cp.mean_reduce(g, axes, cp.CommPlan(k, intra=("data",)))
             for k in PLAN_CHECK_KINDS}
    ref = means["allreduce"]

    def close(x):
        return bool(torch.allclose(x, ref, rtol=1e-6, atol=1e-7))
    return dict(
        n=g.numel(), max_abs=ref.abs().max().item(),
        max_abs_diff={k: (v - ref).abs().max().item()
                      for k, v in means.items()},
        rs_ag_bitwise=bool(torch.equal(
            means["reduce_scatter_allgather"].view(torch.int32),
            ref.view(torch.int32))),
        hierarchical_close=close(means["hierarchical"]),
        gather_all_close=close(means["gather_all"]))


if __name__ == "__main__":
    main()
