# Hand-written CUDA kernels for Hopper, bound with ctypes.
#
# Layout: csrc/<name>.cu holds one kernel with a plain C interface,
# build.py compiles it with nvcc at first use, <name>.py is its wrapper
# (checks, launch, launch counter) beside its plain PyTorch version,
# ref.py names the plain versions as repro.kernels.ref does, and ops.py is
# the public wrapper layer.  Nothing here imports triton or compiles at
# import time: the CPU tests import every module.
