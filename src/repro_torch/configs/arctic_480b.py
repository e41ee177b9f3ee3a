"""arctic-480b  [moe] — 128 routed top-2 experts + dense FFN residual.

[hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, ParallelPlan, register

CONFIG = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    rope="rope",
    moe=MoEConfig(n_experts=128, top_k=2, dense_residual=True),
    # adafactor: adam fp32 states for 480B params (3.8 TB) exceed a 256-chip
    # v5e pod's 4 TB HBM; factored second moment is the production choice
    # (PaLM/T5) and is what makes this arch fit (see DESIGN.md §5).
    plan=ParallelPlan(dp_mode="fsdp", optimizer="adafactor", remat="full",
                      fsdp_shard_pods=True, param_dtype="bfloat16",
                      serve_moe_ep_data=True),
))
