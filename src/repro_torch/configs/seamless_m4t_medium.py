"""seamless-m4t-medium  [audio] — enc-dec, multimodal.  [arXiv:2308.11596; hf]

Backbone-only: the speech frontend is a STUB — ``input_specs()`` supplies
precomputed frame embeddings for the encoder; the decoder consumes text
tokens.  12 encoder + 12 decoder layers.
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig, ParallelPlan, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,               # decoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    rope="none",               # seamless uses learned/relative pos; we use
                               # sinusoidal abs pos for the backbone stub
    encdec=EncDecConfig(enc_layers=12, frontend_dim=1024),
    plan=ParallelPlan(dp_mode="ddp", zero1=True, optimizer="adamw",
                      remat="full"),
))
