"""qwen2-vl-7b  [vlm] — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Backbone-only per assignment: the vision patch-embedding frontend is a STUB —
``input_specs()`` supplies precomputed patch/text embeddings plus the 3-axis
M-RoPE position ids.
"""
from repro_torch.configs.base import ArchConfig, ParallelPlan, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    rope="mrope",
    plan=ParallelPlan(dp_mode="fsdp", optimizer="adamw", remat="full"),
))
