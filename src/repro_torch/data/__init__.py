"""Deterministic synthetic LM data, and the dry run's batch stand-ins."""
from .pipeline import SyntheticLMData, make_batch_specs

__all__ = ["SyntheticLMData", "make_batch_specs"]
