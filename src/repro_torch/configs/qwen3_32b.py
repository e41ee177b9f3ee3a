"""qwen3-32b  [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchConfig, ParallelPlan, register

CONFIG = register(ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    rope="rope",
    plan=ParallelPlan(dp_mode="fsdp", optimizer="adamw", remat="full",
                      serve_fsdp=True),
))
