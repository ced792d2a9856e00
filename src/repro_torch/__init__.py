"""PyTorch + CUDA port of the ``repro`` temporal graph system.

Mirrors ``repro`` file for file (``repro/core/reconstruct.py`` is
``repro_torch/core/reconstruct.py``), imports ``torch`` and ``numpy``
only, and runs every kernel as hand-written CUDA C++ for Hopper
(``repro_torch.kernels``): the four graph kernels of the in-memory
``GraphSession`` and the two of the decoder LM (``repro_torch.models``),
which serve its prefill and the forward of its training step
(``repro_torch.launch.train``).

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``; without a CUDA device that default raises instead of
quietly running on the CPU.  Pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels (what the CPU tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for
    and absent (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is present; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def not_ported(what: str, step: str):
    """Raise for an argument that leads off the ported slice, naming
    the ROADMAP step that will port it."""
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP step {step})")
