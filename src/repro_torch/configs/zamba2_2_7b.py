"""zamba2-2.7b  [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ArchConfig, ParallelPlan, SSMConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    rope="rope",
    block_pattern="zamba2",
    ssm=SSMConfig(state_dim=64, head_dim=64, attn_every=6),
    sub_quadratic=True,   # SSM decode is O(1)-state; runs long_500k
    plan=ParallelPlan(dp_mode="ddp", zero1=True, optimizer="adamw",
                      remat="full"),
))
