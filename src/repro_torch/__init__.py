"""Nuri on PyTorch: the subgraph-discovery engine ported from ``repro``
(JAX, TPU) to PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The package mirrors ``repro``'s layout module for module (``core``,
``kernels``, ``data``, ``obs``) and imports nothing of it.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its plain PyTorch version.
"""
