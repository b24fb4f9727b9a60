"""Nuri core: the paper's computational models on PyTorch."""
