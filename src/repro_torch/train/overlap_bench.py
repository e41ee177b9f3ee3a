"""Measured serial-vs-overlapped DDP step times (paper Fig 2).  Counterpart
of ``repro.train.overlap_bench``.

Times the three schedules of the segmented DDP step
(``repro_torch.train.overlap``):

  ``overlap``  each bucket aggregated right after the backward stage that
               completes it, on a side stream (the paper's optimized
               baseline);
  ``serial``   the same flushes on the same side stream, all after the
               backward;
  ``unfused``  the backward, then every bucket on the compute stream, then
               the update (the no-overlap strawman; skipped under
               ``--accum > 1``).

Each schedule has its own setup (model, optimizer and compressor state);
the steps run round robin, one step of each schedule per rep, so drift on
the machine hits every schedule alike, and the minimum over the reps is
kept.  A step is timed on the host clock between two
``torch.cuda.synchronize()`` calls.  On one rank the data axis has size 1
and, as in the JAX package, is dropped from the aggregation;
``--keep-data-axis`` points the aggregator back at it (the collectives are
then copies, and the compressors and the side stream still run).  The last
line of standard output is the JSON record, with the JAX bench's keys
(``t_serial_us``, ``t_overlap_us``, ``t_unfused_us``) beside ``step_ms``;
``MeasuredBackend`` reads it for a ``kind="train"`` cell:

    python -m repro_torch.train.overlap_bench --full-size --zero1 \\
        --batch 4 --seq 512 --keep-data-axis
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def timed_interleaved(setups: dict, steps: dict, batch: dict, reps: int,
                      warmup: int, lr: float = 1e-3,
                      out: "dict | None" = None) -> dict:
    """Min-of-reps step time (s) per schedule, measured round robin;
    ``setups`` and ``steps`` map each schedule to its own setup and step
    function.  Each schedule threads its own state.  With ``out``, each
    schedule's last state and its losses (read after the timed region)
    go to ``out[schedule] = {"state": ..., "losses": [...]}``."""
    import torch

    from repro_torch.train import train_step as ts
    runs = {k: [ts.init_state(setups[k], seed=0), steps[k], [], []]
            for k in steps}
    for i in range(warmup + reps):
        for k, run in runs.items():
            state, step, times, losses = run
            cuda = setups[k].device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(setups[k].device)
            t0 = time.perf_counter()
            run[0], metrics = step(state, batch, lr)
            if cuda:
                torch.cuda.synchronize(setups[k].device)
            if i >= warmup:
                times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
            del state, metrics
    if out is not None:
        out.update({k: {"state": run[0], "losses": run[3]}
                    for k, run in runs.items()})
    return {k: min(run[2]) for k, run in runs.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full-size", action="store_true",
                    help="the full config (default: the reduced one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--method", default="none",
                    help="plan.compression for the aggregated buckets")
    ap.add_argument("--plan", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="extra ParallelPlan override (repeatable; wins over "
                         "the flags)")
    ap.add_argument("--zero1", action="store_true",
                    help="owner-shard the optimizer state (plan.zero1)")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches per step (the unfused strawman is "
                         "skipped when > 1)")
    ap.add_argument("--comm", default="auto",
                    help="auto|allreduce|reduce_scatter_allgather|"
                         "gather_all|reduce_to_owner_broadcast (zero1 and "
                         "--method none only)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="bucket byte target (default: the arch's)")
    ap.add_argument("--keep-data-axis", action="store_true",
                    help="aggregate over the data axis even on one rank")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--json", action="store_true",
                    help="the JAX bench's flag; the record is always the "
                         "last stdout line")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs import base as cfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.experiments.backend import coerce_kv
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import overlap
    from repro_torch.train import train_step as ts

    dev = mesh_mod.local_device(args.device)
    joined = not dist.is_initialized()      # leave a caller's group alone
    mesh_mod.init_world(dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        arch = cfgs.get(args.arch)
        if not args.full_size:
            arch = cfgs.reduced(arch)
        overrides = dict(dp_mode="ddp", zero1=args.zero1, overlap=True,
                         compression=args.method, comm=args.comm)
        if args.bucket_mb is not None:
            overrides["bucket_mb"] = args.bucket_mb
        plan_overrides = {}
        for kv in args.plan:
            k, _, v = kv.partition("=")
            plan_overrides[k] = coerce_kv(v)
        overrides.update(plan_overrides)        # explicit --plan wins

        def setup_of():
            setup = ts.build(arch, dev, **overrides)
            if args.keep_data_axis:
                setup.agg_cfg = dataclasses.replace(
                    setup.agg_cfg, compress_axes=("data",), raw_axes=())
            return setup
        names = ["overlap", "serial"] + (["unfused"] if args.accum == 1
                                         else [])
        setups = {k: setup_of() for k in names}
        steps = {k: overlap.make_unfused_step(setups[k]) if k == "unfused"
                 else overlap.make_step(setups[k], k, accum=args.accum)
                 for k in names}
        per = args.batch // world
        batch = {k: v[rank * per:(rank + 1) * per] for k, v in batch_at(
            DataConfig(vocab=arch.vocab, seq_len=args.seq,
                       global_batch=args.batch), 0).items()}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t = timed_interleaved(setups, steps, batch, args.reps, args.warmup)
        setup = setups["overlap"]
        rec = dict(
            arch=arch.name, device=torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu", workers=world,
            method=args.method, zero1=args.zero1, accum=args.accum,
            comm=args.comm, plan_overrides=plan_overrides or None,
            batch=args.batch, seq=args.seq,
            n_buckets=setup.layout.n_buckets,
            effective_schedule=overlap.effective_schedule(setup),
            reps=args.reps, warmup=args.warmup,
            step_ms={k: v * 1e3 for k, v in t.items()},
            t_serial_us=t["serial"] * 1e6, t_overlap_us=t["overlap"] * 1e6,
            overlap_vs_serial=t["overlap"] / t["serial"],
            fig2_saving_pct=(1 - t["overlap"] / t["serial"]) * 100,
            peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
        if "unfused" in t:
            rec["t_unfused_us"] = t["unfused"] * 1e6
        if rank == 0:
            print(f"[overlap_bench] {rec['arch']} on {rec['device']} "
                  f"method={rec['method']} p={world} zero1={rec['zero1']} "
                  f"accum={rec['accum']} buckets={rec['n_buckets']}: "
                  + ", ".join(f"{k} {v:.2f} ms"
                              for k, v in rec["step_ms"].items()),
                  flush=True)
            print(json.dumps(rec), flush=True)
        return rec
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
