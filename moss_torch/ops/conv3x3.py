"""3x3 SAME conv + bias (+ relu) over one NHWC image: csrc/conv3x3.cu and its plain version.

Port of tools/conv_pallas_proto.py::conv3x3_fused (:49-82), the TPU's fused
conv for the LPIPS VGG layer, in its layout: x (H, W, Cin), w (3, 3, Cin,
Cout) HWIO, b (Cout,). Like conv3x3_fused, the wrapper casts w and b to x's
type before the kernel, so in bf16 the bias is rounded to bf16 and then
added in f32; products are summed in f32 and the output is rounded once to
out_dtype (x's type by default). On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from . import cuda_build

# kernel launches since the last reset (set to 0 to count a run)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# x, w, b, out; H, W, cin, cout, relu, in_bf16, out_bf16
_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7


@contextmanager
def _full_f32():
    """cuDNN's f32 convolutions in full f32: it takes TF32 by default."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def conv3x3_plain(x, w, b, relu: bool = True, out_dtype=None):
    """tools/conv_pallas_proto.py::ref_conv (:85-89) on the kernel's inputs:
    w and b in x's type, an f32 F.conv2d of them, + b, relu, out_dtype."""
    out_dtype = out_dtype or x.dtype
    w, b = w.to(x.dtype), b.to(x.dtype)
    with _full_f32():
        y = F.conv2d(x.float().permute(2, 0, 1)[None], w.float().permute(3, 2, 0, 1),
                     padding=1)[0].permute(1, 2, 0)
    y = y + b.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def conv3x3(x, w, b, relu: bool = True, out_dtype=None):
    """(H, W, Cout) = relu(conv3x3(x, w) + b), SAME padding."""
    global launches
    out_dtype = out_dtype or x.dtype
    if x.dim() != 3 or x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"conv3x3: x must be (H, W, Cin) f32 or bf16 and out_dtype one of "
                         f"those, got {x.dtype} {tuple(x.shape)} -> {out_dtype}")
    H, W, cin = x.shape
    if w.shape[:3] != (3, 3, cin) or w.dim() != 4 or tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"conv3x3: w must be (3, 3, {cin}, Cout) and b (Cout,), got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3x3: x, w and b must be on one device")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu, out_dtype)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"conv3x3: x must be a contiguous CPU or CUDA tensor, got {x.device}")
    w = w.to(x.dtype).contiguous()
    b = b.to(x.dtype).contiguous()
    out = torch.empty((H, W, w.shape[3]), dtype=out_dtype, device=x.device)
    cuda_build.launch("conv3x3", "moss_conv3x3", _SIGNATURE, x.device,
                      x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), H, W, cin,
                      w.shape[3], int(relu), int(x.dtype == torch.bfloat16),
                      int(out_dtype == torch.bfloat16))
    launches += 1
    return out
