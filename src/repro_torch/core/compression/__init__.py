from repro_torch.core.compression.base import (  # noqa: F401
    Compressor, CompressorSpec, Payload, from_plan, make, plan_kwargs,
    reduce_payload, register_compressor, registry)
