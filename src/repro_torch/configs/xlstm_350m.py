"""xlstm-350m  [ssm] — sLSTM + mLSTM blocks.  [arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up/down projections (mLSTM expand=2,
sLSTM gated FFN), so there is no separate transformer FFN.
"""
from repro_torch.configs.base import ArchConfig, ParallelPlan, SSMConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    rope="none",
    block_pattern="xlstm",
    ssm=SSMConfig(state_dim=256, head_dim=256, slstm_every=8),
    sub_quadratic=True,
    plan=ParallelPlan(dp_mode="ddp", zero1=True, optimizer="adamw",
                      remat="full"),
))
