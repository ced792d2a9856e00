# Hand-written CUDA C++ kernels for Hopper (sm_90a), one package per
# TPU kernel of ``repro.kernels``: ``<name>.cu`` (the kernel),
# ``ops.py`` (wrapper: checks, launch, launch counter; plain version
# for CPU tensors) and ``ref.py`` (the plain PyTorch version).
