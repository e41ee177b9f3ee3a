"""tinyllama-1.1b  [dense] — llama2-arch small.  [arXiv:2401.02385; hf]

This is the paper-representative arch: small enough to replicate (DDP), so it
exercises the paper-faithful path — bucketed gradients + pluggable compressor
on the DP axes (the PyTorch-DDP-comm-hook analogue), with ZeRO-1 optimizer
state sharding.
"""
from repro_torch.configs.base import ArchConfig, ParallelPlan, register

CONFIG = register(ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    rope="rope",
    plan=ParallelPlan(dp_mode="ddp", zero1=True, optimizer="adamw",
                      remat="full"),
))
