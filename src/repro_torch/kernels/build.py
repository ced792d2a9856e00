"""Build, load and count the hand-written CUDA kernels.

All ``.cu`` sources plus the one binding file (``binding.cpp``, the only
one that includes PyTorch's headers) go to ONE
``torch.utils.cpp_extension.load`` call, compiled for ``sm_90a`` into
``build/torch_ext/`` at the repository root (listed in ``.gitignore``)
at first use — never at import, so CPU-only hosts import every module.
ninja compiles the sources in parallel.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a
wrapper adds one where it launches its kernel and nowhere else, so a
run can show that the main path went through the kernels.
"""
from __future__ import annotations

import functools
import os

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(_ROOT, "build", "torch_ext")

SOURCES = (
    "binding.cpp",
    "delta_apply/delta_apply.cu",
    "edge_delta_apply/edge_delta_apply.cu",
    "degree_series/degree_series.cu",
    "evolve_sweep/sweep.cu",
    "flash_attention/flash_attention.cu",
    "ssd_scan/ssd_scan.cu",
)
# ``-Xptxas=-v``: ptxas reports registers, shared memory and spills of
# every kernel instance; the report is shown only by ``load(verbose=True)``
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas=-v")

KERNELS = ("delta_apply", "edge_delta_apply", "degree_series",
           "sweep_series", "flash_attention", "ssd_scan")
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
# of those, the launches on one block of a sharded state (B1 on a row
# block, B2 on a slot block): a multi-device run shows its groups ran
# their kernels on the blocks
BLOCK_LAUNCHES: dict[str, int] = {"delta_apply": 0, "edge_delta_apply": 0}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
    for k in BLOCK_LAUNCHES:
        BLOCK_LAUNCHES[k] = 0


def load(verbose: bool = False):
    """Build the extension where its sources or flags changed, and load
    it.  ``verbose`` prints the build's output, ptxas's report
    included; the flags, and so the build, are the same either way."""
    from torch.utils.cpp_extension import load as load_extension
    os.makedirs(BUILD_DIR, exist_ok=True)
    return load_extension(name="repro_torch_kernels",
                          sources=[os.path.join(_HERE, s) for s in SOURCES],
                          build_directory=BUILD_DIR,
                          extra_cflags=["-O3"],
                          extra_cuda_cflags=list(CUDA_FLAGS),
                          verbose=verbose)


@functools.cache
def ext():
    """The compiled extension module (built on first call)."""
    return load()


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an int for the launch."""
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               ndim: int | None = None) -> None:
    """A kernel operand must be a contiguous CUDA tensor of ``dtype``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name: str, t: torch.Tensor, elems: int = 1) -> None:
    """A kernel that copies ``t`` in 16-byte pieces (``cp.async``) needs
    its start 16-byte aligned and every stride it steps along between
    rows (the outer dims longer than one) a multiple of ``elems``
    elements."""
    if t.numel() and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    bad = [st for sz, st in zip(t.shape[:-1], t.stride()[:-1])
           if sz > 1 and st % elems]
    if bad:
        raise ValueError(f"{name} strides {tuple(t.stride())} must be "
                         f"multiples of {elems} elements")


def check_same_device(**tensors: torch.Tensor) -> None:
    """Every operand of one launch must live on the same card."""
    devices = {t.device for t in tensors.values()}
    if len(devices) > 1:
        raise ValueError("kernel operands on different devices: "
                         + ", ".join(f"{k}={t.device}"
                                     for k, t in tensors.items()))
