"""Synthetic training data: a copy of ``repro.data`` (numpy only)."""
from .pipeline import DataConfig, SyntheticLMData, markov_transition

__all__ = ["DataConfig", "SyntheticLMData", "markov_transition"]
