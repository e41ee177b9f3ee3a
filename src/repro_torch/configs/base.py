"""Architecture / run configuration system (a copy of ``repro.configs.base``).

Every selectable architecture (``--arch <id>``) is a frozen ``ArchConfig``
registered in ``REGISTRY``.  Configs are pure data: models, sharding, the
dry-run and the perf model all read from here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

Family = str  # "dense" | "moe" | "hybrid" | "ssm" | "vlm" | "audio"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared: int = 0             # shared (always-on) experts, qwen2-moe style
    dense_residual: bool = False  # arctic: dense FFN residual in parallel w/ MoE
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64           # Mamba2 / mLSTM state size
    conv_dim: int = 4             # Mamba2 depthwise conv width
    expand: int = 2               # Mamba2 inner expansion
    head_dim: int = 64            # SSD head dim
    chunk: int = 256              # SSD chunk length
    # hybrid (zamba2): one shared attention block applied every
    # `attn_every` mamba blocks (zamba2 shares weights across applications)
    attn_every: int = 6
    # xlstm: 1 sLSTM block every `slstm_every` mLSTM blocks
    slstm_every: int = 8


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 0           # encoder depth (seamless: 12 enc + 12 dec)
    frontend_dim: int = 0         # stubbed modality frontend embedding dim


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Per-arch distribution defaults (overridable by the launcher)."""
    dp_mode: str = "fsdp"         # "ddp" | "fsdp"
    zero1: bool = False           # ddp-mode: shard optimizer state over DP
    # fsdp-mode: shard params over the pod axis too (full ZeRO-3).  Default
    # False = HSDP: shard intra-pod, replicate across pods, leaving a
    # pod-axis gradient reduction for the compressor (the paper's hook).
    # arctic-480b needs True to fit (DESIGN.md §5) — and then has no
    # DP-gradient exchange left to compress.
    fsdp_shard_pods: bool = False
    seq_parallel: bool = True     # Megatron-SP: shard norms/residual over seq
    remat: str = "full"           # "none" | "full" | "dots"
    optimizer: str = "adamw"      # "adamw" | "adafactor" | "sgdm"
    # gradient compression policy on DP axes ("none"|"powersgd"|"signsgd"|
    # "mstopk"|"randomk"|"qsgd").  `compress_axes` selects which DP mesh axes
    # the compressor runs on; the default "pod" operationalizes the paper's
    # finding: compress only the low-bandwidth (DCN) axis.
    compression: str = "none"
    compress_axes: str = "pod"    # "pod" | "all"
    # collective schedule moving each aggregation payload (a CommPlan kind,
    # docs/comm_api.md): "auto" (resolve from payload associativity — the
    # historic dispatch) | "allreduce" | "reduce_scatter_allgather" |
    # "reduce_to_owner_broadcast" (zero1 + uncompressed only: the owner's
    # updated params ride the broadcast leg, halving exchanged bytes) |
    # "gather_all" | "hierarchical[:intra+axes]".  Associativity VALIDATES
    # the choice instead of dispatching it.
    comm: str = "auto"
    powersgd_rank: int = 4
    topk_frac: float = 0.01
    qsgd_bits: int = 8
    error_feedback: bool = True
    # DDP bucket byte target (paper: PyTorch default 25MB).  Fractional
    # values are for smoke scale (ZeRO-1 owner sharding needs
    # n_buckets >= p_dp to be non-degenerate).
    bucket_mb: float = 25
    # DDP only: fuse reverse-order bucketed aggregation into the backward
    # pass (leaf-aligned buckets + segmented per-block vjp; the paper's
    # optimized-syncSGD baseline, §2.2).  repro.train.overlap; degrades to
    # the serial schedule for non-associative compressors (Table 3).
    overlap: bool = False
    # launch-time adaptive compression (docs/adaptive.md): let the perf
    # model pick compression/comm/overlap before the step is built
    # (repro.adaptive.controller.resolve_plan).  Resolved plans carry
    # adaptive=False, so the rest of the stack only ever sees static
    # plans; the fallback choice is overlapped syncSGD.
    adaptive: bool = False
    # training parameter storage dtype.  "bfloat16" = T5X-style low-memory
    # training (bf16 weights + fp32 adafactor stats) — what makes
    # arctic-480b's 1.9 TB of fp32 masters unnecessary (DESIGN.md §5).
    param_dtype: str = "float32"
    # serving: shard bf16 params over "data" too (gather-at-use) when
    # TP-only residency would blow 16 GB/chip (qwen3-32b, arctic)
    serve_fsdp: bool = False
    # serving MoE: 2D expert sharding — experts over "data" (EP), d_ff over
    # "model" (TP) — residency without per-layer gathers (arctic)
    serve_moe_ep_data: bool = False
    # beyond-paper (§Perf): int8-quantized FSDP param gathers ("none"|"int8")
    gather_quant: str = "none"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                     # 0 => d_model // n_heads
    qk_norm: bool = False                 # qwen3
    rope: str = "rope"                    # "rope" | "mrope" | "none"
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    ssm: SSMConfig = dataclasses.field(default_factory=SSMConfig)
    encdec: EncDecConfig = dataclasses.field(default_factory=EncDecConfig)
    plan: ParallelPlan = dataclasses.field(default_factory=ParallelPlan)
    # which layers are attention vs ssm for hybrids; "all_attn", "zamba2",
    # "xlstm" (see models/)
    block_pattern: str = "all_attn"
    sub_quadratic: bool = False           # True => long_500k shape is runnable
    max_seq: int = 131072

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived quantities used by the perf model ----
    def param_count(self) -> int:
        """Total parameters (exact for the port's model)."""
        from repro_torch.models import registry as model_registry
        return model_registry.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import registry as model_registry
        return model_registry.param_count(self, active_only=True)


REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in REGISTRY, f"duplicate arch {cfg.name}"
    REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    # import side-effect: populate registry
    import repro_torch.configs.all  # noqa: F401
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def names() -> list[str]:
    import repro_torch.configs.all  # noqa: F401
    return sorted(REGISTRY)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A small same-family config for CPU smoke tests."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.family not in ("hybrid", "ssm") else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        head_dim=32,
        max_seq=512,
    )
    if cfg.moe.n_experts:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4,
                                        top_k=min(cfg.moe.top_k, 2),
                                        n_shared=min(cfg.moe.n_shared, 1))
    if cfg.family in ("hybrid", "ssm"):
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk=32,
            attn_every=2, slstm_every=2)
    if cfg.encdec.enc_layers:
        kw["encdec"] = dataclasses.replace(cfg.encdec, enc_layers=2)
    kw["plan"] = dataclasses.replace(cfg.plan, remat="none")
    kw.update(overrides)
    out = dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
    return out
