"""moss_torch: the PyTorch / CUDA (Hopper) port of moss_tpu.

The package mirrors moss_tpu's layout (ops/, models/, render/, data/) and
keeps its numerical contract; the Pallas kernels become hand-written CUDA
kernels under csrc/. It imports neither jax nor anything of moss_tpu.

Entry points (scene/cloud constructors, the converter, render_frame) take a
`device`. Left at None they run on the GPU and raise when there is none: the
plain PyTorch path runs on the CPU only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, else the current GPU."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "moss_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
