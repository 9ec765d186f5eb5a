"""Deterministic synthetic LM data."""
from .pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
