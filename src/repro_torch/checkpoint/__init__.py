"""Atomic checkpoints in the JAX package's format, and the manager that
saves and restores a ``TrainSetup``'s state, elastic across world sizes.
Counterpart of ``repro.checkpoint``."""
