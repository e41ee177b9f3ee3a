"""qwen2-moe-a2.7b  [moe] — 4 shared + 60 routed top-4 experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, ParallelPlan, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    rope="rope",
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4),
    plan=ParallelPlan(dp_mode="fsdp", optimizer="adamw", remat="full"),
))
