"""mistral-nemo-12b  [dense] — 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ArchConfig, ParallelPlan, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    rope="rope",
    max_seq=131072,
    plan=ParallelPlan(dp_mode="fsdp", optimizer="adamw", remat="full"),
))
