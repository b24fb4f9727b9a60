"""Synthetic data graphs (numpy), identical to ``repro``'s generators."""
