"""Serving launcher: batched generation with the Engine.  Counterpart of
``repro.launch.serve``::

    python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --prompts "1 2 3" "7 8 9 10"
    python -m repro_torch.launch.serve --device cpu

Random serving weights from seed 0 (``serving.serve_step.serve_params``)
on the card, or on the CPU with ``--device cpu``; the reduced config
unless ``--full-size``.  The mesh follows the JAX launcher's rule: a
world of 8 or more ranks (``torchrun``) is ``pod 2 x data (world / 4) x
model 2``, one rank is one rank.  Rank 0 prints one ``[serve] req i:
prompt=[...] -> [...]`` line per prompt.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prompts", nargs="*", default=["1 2 3", "7 8 9 10"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import base as cfgs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.serving import serve_step as ss
    from repro_torch.serving.engine import Engine, Request

    arch = cfgs.get(args.arch)
    if not args.full_size:
        arch = cfgs.reduced(arch)
    dev = mesh_mod.local_device(args.device)
    mesh_mod.init_world(dev)
    try:
        n = dist.get_world_size()
        if n >= 8:
            if n % 4:
                raise ValueError(f"a world of {n} ranks is not pod 2 x "
                                 f"data {n / 4} x model 2")
            mesh_mod.init_pod_mesh(2, n // 4, dev, tp=2)
        elif n > 1:
            raise ValueError(f"serve runs on one rank or on 8 or more "
                             f"(pod 2 x data world/4 x model 2), not {n}")
        shape = ShapeConfig("serve", "decode", args.cache_len, args.batch)
        setup = ss.build_serve(arch, shape, device=dev)
        ss.serve_params(setup)
        engine = Engine(setup, temperature=args.temperature)
        reqs = [Request(i, [int(t) % arch.vocab for t in p.split()],
                        max_new=args.max_new)
                for i, p in enumerate(args.prompts)]
        done = engine.generate(reqs)
        if dist.get_rank() == 0:
            for r in done:
                print(f"[serve] req {r.rid}: prompt={r.prompt} -> {r.out}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
