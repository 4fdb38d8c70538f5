"""Datasets, checkpoints and weight conversion."""
