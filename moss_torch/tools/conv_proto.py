"""Check csrc/conv3x3.cu, then time it at the LPIPS VGG16 layer shapes.

Counterpart of tools/conv_pallas_proto.py's check() and bench(): the kernel
against its plain version at check()'s three f32 shapes (atol 1e-4, :102),
then each of bench()'s eight VGG16 layer shapes (:123-124) in bf16, with
bench()'s inputs (x N(0, 1), w N(0, 0.05), b = 0), beside its FLOPs
(2 H^2 Cin Cout 9), its bound (the larger of the FLOPs at the H100's 989
TFLOP/s bf16 and the bytes at 3.35 TB/s), the plain f32 version, and one
cuDNN call (F.conv2d + relu in bf16, channels_last) as the library yardstick.
The port never calls cuDNN's conv; the JAX tool's yardstick was the im2col
conv of moss_tpu/ops/lpips_jax.py:133.

    python -m moss_torch.tools.conv_proto

Runs on the GPU; main(device="cpu") runs the plain version on the host.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.conv3x3 import conv3x3, conv3x3_plain
from .timing import device_name, timer

CHECK_SHAPES = ((16, 128, 8, 16), (8, 256, 64, 64), (32, 128, 16, 8))  # (H, W, Cin, Cout)
VGG_LAYERS = ((512, 64, 64), (256, 64, 128), (256, 128, 128), (128, 128, 256),
              (128, 256, 256), (64, 256, 512), (64, 512, 512), (32, 512, 512))  # (H, Cin, Cout)
F32_ATOL = 1e-4   # tools/conv_pallas_proto.py:102
BF16_RTOL = 2e-2  # max |y - y_plain| / max |y_plain|: the bf16 rule of tests/test_losses_parity.py:108
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA datasheet)
PEAK_BYTES = 3.35e12
TIMING = {"n": 10, "reps": 5, "warmup": 2}


def check_inputs(dev):
    """check()'s draws (:93-97): (shape, x, w, b) in f32."""
    rng = np.random.default_rng(0)
    for H, W, cin, cout in CHECK_SHAPES:
        x = rng.normal(size=(H, W, cin)).astype(np.float32)
        w = rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)
        b = rng.normal(0, 0.1, cout).astype(np.float32)
        yield (H, W, cin, cout), *(torch.as_tensor(a, device=dev) for a in (x, w, b))


def layer_inputs(dev):
    """bench()'s draws (:122-128) at VGG_LAYERS: (layer, x, w, b) in f32;
    x from one generator across the layers, w from a fresh one per layer,
    b = 0."""
    rng = np.random.default_rng(0)
    for H, cin, cout in VGG_LAYERS:
        x = rng.normal(size=(H, H, cin)).astype(np.float32)
        w = np.random.default_rng(1).normal(0, 0.05, (3, 3, cin, cout)).astype(np.float32)
        yield (H, cin, cout), *(torch.as_tensor(a, device=dev)
                                for a in (x, w, np.zeros(cout, np.float32)))


def scaled_err(y, ref):
    return float((y.float() - ref.float()).abs().max()) / (float(ref.float().abs().max()) + 1e-30)


def layer_bound(H, cin, cout, itemsize=2):
    """(FLOPs, bytes, bound ms, bound_by) of one layer in bf16: x, w, b read
    once, the output written once."""
    flops = 2 * H * H * cin * cout * 9
    bytes_ = itemsize * (H * H * cin + 9 * cin * cout + cout + H * H * cout)
    t_ops, t_bytes = flops / PEAK_BF16, bytes_ / PEAK_BYTES
    return flops, bytes_, 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def library_conv(x, w, b):
    """cuDNN's conv + relu on the same bf16 data: x as an NCHW view with
    channels_last strides, w as OIHW channels_last."""
    xl = x.permute(2, 0, 1)[None]
    wl = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    return lambda: F.relu(F.conv2d(xl, wl, b, padding=1))


def main(device=None):
    """Print and return the check errors and, per layer, the kernel's,
    plain version's and library's ms with FLOPs and bound."""
    dev = resolve_device(device)
    time_ms = timer(dev)
    print(f"device: {device_name(dev)}")
    checks = []
    for (H, W, cin, cout), x, w, b in check_inputs(dev):
        err = float((conv3x3(x, w, b) - conv3x3_plain(x, w, b)).abs().max())
        print(f"H{H} W{W} {cin}->{cout}: max abs err {err:.2e}")
        if not err <= F32_ATOL:
            raise AssertionError(f"conv3x3 f32 at {(H, W, cin, cout)}: max abs err {err}")
        checks.append(err)

    rows = []
    for (H, cin, cout), x, w, b in layer_inputs(dev):
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        err = scaled_err(conv3x3(x, w, b), conv3x3_plain(x, w, b))
        if not err <= BF16_RTOL:
            raise AssertionError(f"conv3x3 bf16 at {(H, cin, cout)}: scaled err {err}")
        flops, bytes_, bound_ms, bound_by = layer_bound(H, cin, cout)
        ms = time_ms(lambda: conv3x3(x, w, b), **TIMING)
        plain_ms = time_ms(lambda: conv3x3_plain(x, w, b), **TIMING)
        library_ms = time_ms(library_conv(x, w, b.to(torch.bfloat16)), **TIMING)
        print(f"{H:4d}^2 {cin:3d}->{cout:3d}: kernel {ms:7.3f} ms ({flops / ms / 1e9:6.1f} TF/s)"
              f"  bound {bound_ms:7.4f} ms  plain f32 {plain_ms:7.3f} ms"
              f"  F.conv2d bf16 {library_ms:7.3f} ms  scaled err {err:.1e}")
        rows.append({"layer": [H, cin, cout], "flops": flops, "bytes": bytes_, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bf16_scaled_err": err})
    return {"device": device_name(dev), "check_max_abs_err": checks, "layers": rows}


if __name__ == "__main__":
    main()
