"""Hardware presets for the performance model.  Counterpart of
``repro.core.perfmodel.hardware``.

Three presets:
  * the paper's setting (V100 + 10 Gb/s EC2, NCCL ring), which reproduces
    the paper's figures;
  * the CPU host of the measured backends' CPU runs;
  * the port's card, one NVIDIA H100 80GB HBM3 SXM.

The JAX package's ``tpu-v5e`` preset is left out: only its HLO roofline
reads it, and that roofline is not ported.  A spec that names it is an
unknown preset (``status="error"``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # FLOP/s per device (paper: fp32; H100: bf16)
    hbm_bw: float              # bytes/s per device
    # interconnect used by the DP all-reduce
    net_bw: float              # bytes/s per device, one direction
    alpha: float               # per-hop latency (s)
    # all-gather congestion factor (paper App. C: incast on EC2 TCP; 1.0 = none)
    allgather_congestion: float = 1.0
    # secondary (cross-pod) network, bytes/s per device; 0 = single-tier
    dcn_bw: float = 0.0

    def scaled(self, compute: float = 1.0, bandwidth: float = 1.0,
               name: str | None = None) -> "Hardware":
        """What-if scaling (paper Figs 17/18)."""
        return dataclasses.replace(
            self, name=name or f"{self.name}×c{compute:g}b{bandwidth:g}",
            peak_flops=self.peak_flops * compute,
            hbm_bw=self.hbm_bw * compute,
            net_bw=self.net_bw * bandwidth)

    def with_net(self, gbps: float) -> "Hardware":
        return dataclasses.replace(self, name=f"{self.name}@{gbps:g}Gbps",
                                   net_bw=gbps * 1e9 / 8)


# ---- the paper's cluster: p3.8xlarge, 4×V100, ~10 Gb/s per instance ----
V100_EC2 = Hardware(
    name="v100-ec2-10gbps",
    peak_flops=15.7e12,        # V100 fp32 (the paper trains fp32)
    hbm_bw=900e9,
    net_bw=10e9 / 8,           # 10 Gb/s -> bytes/s
    alpha=25e-6,               # fitted per App. C methodology (see calibration)
    allgather_congestion=1.5,  # App. C: incast degrades all-gather (~19% err)
)

# ---- CPU host (the measured backends' CPU runs) ----
# Nominal constants only: the REAL values come from
# ``calibration.calibrate_from_results`` over multi-process pod runs
# (``MultiProcessBackend``), which replaces alpha/net_bw/dcn_bw with the
# fitted α–β of this machine's two gloo tiers (inside a pod and across
# pods).
CPU_HOST = Hardware(
    name="cpu-host",
    peak_flops=5e10,           # order-of-magnitude 1-core AVX fp32
    hbm_bw=2e10,
    net_bw=2e9,                # intra-pod tier
    alpha=50e-6,               # dispatch latency per hop
    allgather_congestion=1.0,
    dcn_bw=5e8,                # cross-pod gloo over loopback
)

# ---- the port's card (data sheet, NVIDIA H100 80GB HBM3 SXM, 700 W) ----
H100 = Hardware(
    name="h100",
    peak_flops=989e12,         # bf16 dense, tensor cores
    hbm_bw=3.35e12,
    net_bw=450e9,              # NVLink 4, per direction
    # nominal, not measured: the pod fit (calibrate_from_results with
    # base_hw=H100) replaces alpha, net_bw and dcn_bw with fitted values
    alpha=10e-6,
    allgather_congestion=1.0,
    dcn_bw=50e9,               # one 400 Gb/s NIC per card across hosts
)

PRESETS = {h.name: h for h in (V100_EC2, CPU_HOST, H100)}
