"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Runs the port's train step as the arch configures it (``tinyllama-1.1b``:
DDP, ZeRO-1 with bf16 working parameters; six archs: FSDP, sharded over
``data``, and over ``pod`` too under ``fsdp_shard_pods``; the line it
prints names the ``fsdp=`` axes, as the JAX launcher's does) on the
card, or on the CPU with ``--device cpu``.  ``--arch`` takes every
registered arch: the dense, MoE, hybrid (``zamba2-2.7b``) and ssm
(``xlstm-350m``) families train; the audio (``seamless-m4t-medium``) and
vlm (``qwen2-vl-7b``) families build, but their steps read
``enc_embeds`` or ``mrope_positions``, which the data pipeline does not
yield (nor does the JAX package's), so the first step raises a
``KeyError`` naming it (``train/pod_worker.py`` feeds them).
``--overlap`` and ``--adaptive`` force ``dp_mode="ddp"`` and say so, as
in the JAX package.
``--accum`` splits each rank's batch into microbatches,
``--overlap`` runs the overlapped step (``repro_torch.train.overlap``:
each bucket aggregated between backward stages) and ``--sync-every N``
averages the parameters over the ``pod`` axis every N steps (local SGD).
``--adaptive`` lets the perf model pick the compression and comm plan for
this world size and batch before the step is built
(``adaptive.controller.resolve_plan``; overlapped syncSGD when nothing is
predicted to win).  ``--ckpt-dir`` resumes from the newest checkpoint
there and saves every ``--ckpt-every`` steps and at the end; SIGTERM or
SIGINT ends the run after the step under way, with a checkpoint.  Every
plan saves (FSDP, HSDP, ``--tp``, the pod mesh): each rank writes its
slices of the sharded leaves into the JAX package's global layout, and a
run restores the
newest checkpoint at another world, FSDP degree or ``--tp`` too
(``checkpoint.manager``).
As in the JAX package, a reduction axis of size 1 is dropped, so a
one-rank run aggregates nothing.

``--tp N`` adds the ``model`` axis of size N, innermost (the JAX
package's ``make_pod_mesh(..., tp)``; every family): with ``--mesh
local`` the world is ``data x model``
(``launch.mesh.init_mesh``), with ``--mesh pod`` ``pod x data x model``
and ``procs x local-devices x tp`` ranks.  Each rank reads the rows of
its DP coordinate.

Meshes: ``--mesh local`` (default) puts every rank on one ``data`` axis;
``--mesh pod`` builds the two-tier ``pod x data`` mesh
(``launch.mesh.init_pod_mesh``) of ``--procs`` pods of
``--local-devices`` ranks each.  One torch process drives one rank, so
the JAX package's process of ``--local-devices`` devices is here
``--local-devices`` processes, and the world has ``procs x
local-devices`` ranks.  Under ``torchrun`` each process joins the group
from its environment and drives ``cuda:(LOCAL_RANK % device_count)``, so
several ranks may share a card (then every collective is gloo).  Without
``torchrun``, ``--mesh pod`` starts each rank by hand on this host:
``--proc-id`` is its rank and ``--coordinator`` the ``host:port`` that
rank 0 binds (they become ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``)::

    python -m repro_torch.launch.train --arch tinyllama-1.1b --full-size \\
        --steps 3 --batch 4 --seq 512 --compression powersgd
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --mesh pod --procs 2 --local-devices 2 \\
        --compress-axes pod --compression powersgd --steps 2 --batch 8
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced smoke size)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--mesh", default="local", choices=["local", "pod"],
                    help="local: one data axis over every rank; pod: "
                         "--procs pods x --local-devices ranks")
    ap.add_argument("--procs", type=int, default=2,
                    help="--mesh pod: the pod axis (the slow, gloo tier)")
    ap.add_argument("--local-devices", type=int, default=2,
                    help="--mesh pod: ranks per pod (the data axis)")
    ap.add_argument("--tp", type=int, default=1,
                    help="the model axis (tensor, sequence and expert "
                         "parallelism), innermost")
    ap.add_argument("--proc-id", type=int, default=None,
                    help="--mesh pod without torchrun: this process's rank")
    ap.add_argument("--coordinator", default="127.0.0.1:12355",
                    help="--mesh pod without torchrun: host:port that "
                         "rank 0 binds")
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
    ap.add_argument("--compress-axes", default=None, choices=["pod", "all"],
                    help="pod: raw mean over data, compressor over pod "
                         "(on one pod: over data); all: compressor over "
                         "every DP axis")
    ap.add_argument("--comm", default=None,
                    help="auto|allreduce|reduce_scatter_allgather|"
                         "gather_all|hierarchical[:intra+axes]|"
                         "reduce_to_owner_broadcast (the last needs zero1 "
                         "and --compression none)")
    ap.add_argument("--overlap", action="store_true",
                    help="segmented backward with each bucket aggregated "
                         "between backward stages (the paper's optimized "
                         "syncSGD baseline); forces dp_mode=ddp")
    ap.add_argument("--adaptive", action="store_true",
                    help="let the perf model pick compression/comm at "
                         "launch (falls back to overlapped syncSGD when no "
                         "win is predicted); forces dp_mode=ddp")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="local SGD: average the parameters over the pod "
                         "axis every N steps")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from the newest checkpoint here and save "
                         "to it")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save every N steps (0: only at the end)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import base as cfgs
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import train_step as ts
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.mesh == "pod" and args.proc_id is not None:
        mesh_mod.set_rank_env(args.proc_id,
                              args.procs * args.local_devices * args.tp,
                              args.coordinator)
    dev = mesh_mod.local_device(args.device)
    mesh_mod.init_world(dev)
    data = None
    try:
        if args.mesh == "pod":
            mesh_mod.init_pod_mesh(args.procs, args.local_devices, dev,
                                   tp=args.tp)
        elif args.tp > 1:
            mesh_mod.init_mesh(args.tp, dev)
        rank, world = dist.get_rank(), dist.get_world_size()
        dp_axes = mesh_mod.present_axes()
        dp_rank, p_dp = mesh_mod.rank(dp_axes), mesh_mod.size(dp_axes)
        arch = cfgs.get(args.arch)
        if not args.full_size:
            arch = cfgs.reduced(arch)
        overrides = {}
        if args.compression:
            overrides["compression"] = args.compression
        if args.compress_axes:
            overrides["compress_axes"] = args.compress_axes
        if args.comm:
            overrides["comm"] = args.comm
        if args.overlap:
            if arch.plan.dp_mode != "ddp" and rank == 0:
                print(f"[train] --overlap: dp_mode {arch.plan.dp_mode!r} -> "
                      f"'ddp' (overlap interleaves DDP bucket collectives)",
                      flush=True)
            overrides.update(overlap=True, dp_mode="ddp")
        if args.adaptive:
            import dataclasses

            from repro_torch.adaptive import controller as actl
            plan = dataclasses.replace(arch.plan, **overrides)
            if plan.dp_mode != "ddp" and rank == 0:
                print(f"[train] --adaptive forces dp_mode='ddp' (arch plan "
                      f"had dp_mode={plan.dp_mode!r})", flush=True)
            plan, decision = actl.resolve_plan(plan, arch, n_dev=p_dp,
                                               batch=args.batch,
                                               seq=args.seq)
            if rank == 0:
                print(f"[train] adaptive: scheme={decision.scheme} "
                      f"comm={decision.comm} predicted "
                      f"{decision.t_pred * 1e3:.3f} ms/step vs overlapped "
                      f"syncSGD {decision.t_base * 1e3:.3f} ms/step",
                      flush=True)
            arch = dataclasses.replace(arch, plan=plan)
            overrides = {}
        setup = ts.build(arch, dev, **overrides)
        if rank == 0:
            sched = ""
            if setup.overlap:
                from repro_torch.train import overlap as overlap_mod
                sched = f" schedule={overlap_mod.effective_schedule(setup)}"
            print(f"[train] arch={arch.name} device={dev} world={world} "
                  f"mesh={mesh_mod.axis_sizes()} "
                  f"backends={mesh_mod.backends()} "
                  f"dp_mode={setup.arch.plan.dp_mode} zero1={setup.zero1} "
                  f"fsdp={setup.fsdp_axes} tp={setup.tp} "
                  f"sp={setup.model.ctx.seq_parallel} "
                  f"optimizer={setup.opt_cfg.name} "
                  f"overlap={setup.overlap}{sched} "
                  f"params={str(setup.layout.dtype).removeprefix('torch.')} "
                  f"accum={args.accum} sync_every={args.sync_every} "
                  f"agg={setup.agg_cfg.compressor}@"
                  f"{setup.agg_cfg.compress_axes} raw@"
                  f"{setup.agg_cfg.raw_axes} comm={setup.comm.spec_str()} "
                  f"buckets={setup.layout.n_buckets}", flush=True)
        data = Pipeline(DataConfig(vocab=arch.vocab, seq_len=args.seq,
                                   global_batch=args.batch, seed=args.seed),
                        host=dp_rank, num_hosts=p_dp)
        tcfg = TrainerConfig(
            total_steps=args.steps,
            log_every=args.log_every if rank == 0 else 0,
            accum=args.accum, sync_every=args.sync_every,
            ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
            schedule=ScheduleConfig(peak_lr=args.lr,
                                    warmup_steps=args.warmup,
                                    total_steps=args.steps))
        trainer = Trainer(setup, tcfg, data)
        sync = ts.local_sgd_sync(setup) if args.sync_every > 1 else None
        if sync is not None:
            def checked_sync(state):
                state = sync(state)
                same = ts.params_agree(state["params"], ("pod",))
                if rank == 0:
                    print(f"[train] step {state['step']}: parameters "
                          f"averaged over pod; the same bits on every pod: "
                          f"{same}", flush=True)
                return state
            trainer.sync_fn = checked_sync
        state = trainer.run(args.seed)
        if rank == 0:
            print(f"[train] done at step {state['step']}", flush=True)
    finally:
        if data is not None:
            data.close()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
