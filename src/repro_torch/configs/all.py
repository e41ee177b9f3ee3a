"""Registers every architecture the port supports so far (one: the
dense ``tinyllama-1.1b`` of the first slice)."""
from repro_torch.configs import tinyllama_1_1b  # noqa: F401
