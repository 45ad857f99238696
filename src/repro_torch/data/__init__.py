"""Deterministic, step-resumable synthetic data pipeline."""
from .synthetic import SyntheticDataset
