"""Spectral-gating pipelines."""
