"""Datasets, checkpoints, weight conversion and profiling."""
