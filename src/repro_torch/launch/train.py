"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Runs the port's DDP step as the arch configures it (``tinyllama-1.1b``:
ZeRO-1 with bf16 working parameters) on the card, or on the CPU with
``--device cpu``; ``--accum`` splits each rank's batch into microbatches,
and ``--overlap`` runs the overlapped step (``repro_torch.train.overlap``:
each bucket aggregated between backward stages).  Under ``torchrun`` each process
joins the group from its environment and drives ``cuda:LOCAL_RANK``;
without it the run is a group of one rank.  As in the JAX package, a
reduction axis of size 1 is dropped, so a one-rank run aggregates nothing.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --full-size \
        --steps 3 --batch 4 --seq 512 --compression powersgd
"""
from __future__ import annotations

import argparse
import os


def data_iter(cfg, rank: int, world: int):
    """This rank's contiguous slice of each global batch."""
    from repro_torch.data.synthetic import batch_at
    per = cfg.global_batch // world
    step = 0
    while True:
        b = batch_at(cfg, step)
        yield {k: v[rank * per:(rank + 1) * per] for k, v in b.items()}
        step += 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced smoke size)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches per step (gradients summed in fp32)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--compression", default=None,
                    help="none|powersgd|signsgd|qsgd|terngrad|randomk|"
                         "mstopk, or ef:<name> (error feedback; not "
                         "ef:powersgd)")
    ap.add_argument("--comm", default=None,
                    help="auto|allreduce|reduce_scatter_allgather|"
                         "gather_all|reduce_to_owner_broadcast (the last "
                         "needs zero1 and --compression none)")
    ap.add_argument("--overlap", action="store_true",
                    help="segmented backward with each bucket aggregated "
                         "between backward stages (the paper's optimized "
                         "syncSGD baseline); forces dp_mode=ddp")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs import base as cfgs
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import train_step as ts
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    device = args.device
    if device == "cuda" and "LOCAL_RANK" in os.environ:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    dev = mesh_mod.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh_mod.init_world(dev)
    rank, world = dist.get_rank(), dist.get_world_size()

    arch = cfgs.get(args.arch)
    if not args.full_size:
        arch = cfgs.reduced(arch)
    overrides = {}
    if args.compression:
        overrides["compression"] = args.compression
    if args.comm:
        overrides["comm"] = args.comm
    if args.overlap:
        if arch.plan.dp_mode != "ddp" and rank == 0:
            print(f"[train] --overlap: dp_mode {arch.plan.dp_mode!r} -> "
                  f"'ddp' (overlap interleaves DDP bucket collectives)",
                  flush=True)
        overrides.update(overlap=True, dp_mode="ddp")
    setup = ts.build(arch, dev, **overrides)
    if rank == 0:
        print(f"[train] arch={arch.name} device={dev} world={world} "
              f"dp_mode={setup.arch.plan.dp_mode} zero1={setup.zero1} "
              f"overlap={setup.overlap} "
              f"params={str(setup.layout.dtype).removeprefix('torch.')} "
              f"accum={args.accum} "
              f"agg={setup.agg_cfg.compressor}@{setup.agg_cfg.compress_axes}"
              f" comm={setup.comm.spec_str()} buckets="
              f"{setup.layout.n_buckets}", flush=True)
    data = data_iter(DataConfig(vocab=arch.vocab, seq_len=args.seq,
                                global_batch=args.batch, seed=args.seed),
                     rank, world)
    tcfg = TrainerConfig(
        total_steps=args.steps, log_every=args.log_every if rank == 0 else 0,
        accum=args.accum,
        schedule=ScheduleConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                                total_steps=args.steps))
    try:
        state = Trainer(setup, tcfg, data).run(args.seed)
        if rank == 0:
            print(f"[train] done at step {state['step']}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
