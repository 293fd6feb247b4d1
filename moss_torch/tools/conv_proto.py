"""Check csrc/conv3x3.cu, then time it at the LPIPS VGG16 layer shapes.

Counterpart of tools/conv_pallas_proto.py's check() and bench(): the
CUDA-core kernel against its plain version at check()'s three f32 shapes
(atol 1e-4, :102), each with the tile and cluster split the wrapper picks
and a bitwise repeat, and at the eight VGG16 layer shapes (:123-124) in f32;
then the tensor-core kernel at each of those layers in bf16, with bench()'s
inputs (x N(0, 1), w N(0, 0.05), b = 0). Each beside its FLOPs (2 H W Cin Cout 9), its bound
(the larger of the FLOPs at the H100's peak for the unit, 989 TFLOP/s bf16
on the tensor cores or 67 TFLOP/s f32 on the CUDA cores, and the bytes at
3.35 TB/s), the plain version, and one cuDNN call as the library yardstick
(F.conv2d + relu, channels_last; f32 with TF32 off, where it is the plain
version too and is timed once). Per bf16 layer also the ms of each stage of
the tensor-core kernel (ops.conv3x3.STAGES: the copies alone, with the A
loads, the products alone, the wgmmas alone), which say what holds it back.
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
from ..ops.conv3x3 import STAGES, _full_f32, conv3x3, conv3x3_plain, conv3x3_tc_stage, \
    f32_tile, f32_tiles, tc_tile, tc_tiles
from .timing import device_name, timer

CHECK_SHAPES = ((16, 128, 8, 16), (8, 256, 64, 64), (32, 128, 16, 8))  # (H, W, Cin, Cout)
VGG_LAYERS = ((512, 64, 64), (256, 64, 128), (256, 128, 128), (128, 128, 256),
              (128, 256, 256), (64, 256, 512), (64, 512, 512), (32, 512, 512))  # (H, Cin, Cout)
F32_ATOL = 1e-4   # tools/conv_pallas_proto.py:102
BF16_RTOL = 2e-2  # max |y - y_plain| / max |y_plain|: the bf16 rule of tests/test_losses_parity.py:108
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s, tensor cores (NVIDIA datasheet)
PEAK_F32 = 67e12    # f32 FLOP/s on the CUDA cores
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


def layer_bound(H, cin, cout, W=None, itemsize=2, peak=PEAK_BF16):
    """(FLOPs, bytes, bound ms, bound_by) of one (H, W) layer: x, w, b read
    once, the output written once; operations at `peak` FLOP/s."""
    W = H if W is None else W
    flops = 2 * H * W * cin * cout * 9
    bytes_ = itemsize * (H * W * cin + 9 * cin * cout + cout + H * W * cout)
    t_ops, t_bytes = flops / peak, bytes_ / PEAK_BYTES
    return flops, bytes_, 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def library_conv(x, w, b):
    """cuDNN's conv + relu on the same data, in its type: x as an NCHW view
    with channels_last strides, w as OIHW channels_last."""
    xl = x.permute(2, 0, 1)[None]
    wl = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)

    def call():
        with _full_f32():
            return F.relu(F.conv2d(xl, wl, b, padding=1))

    return call


def f32_choice(H, W, cin, cout, dev):
    """The CUDA-core kernel's tile (the C library's dict) and cluster split
    for a shape, and its grid's CTAs; None off the card."""
    if dev.type != "cuda":
        return None
    tiles = f32_tiles(dev)
    code, split = f32_tile(H, W, cin, cout, tiles,
                           torch.cuda.get_device_properties(dev).multi_processor_count)
    t = tiles[code]
    ctas = -(-H // t["rows"]) * -(-W // 16) * -(-cout // t["channels"]) * split
    return {"code": code, **t, "split": split, "ctas": ctas}


def f32_row(shape, x, w, b, time_ms):
    """One f32 shape (H, W, Cin, Cout) on the CUDA-core kernel: its error
    against the plain version (raising past F32_ATOL), a bitwise repeat,
    its ms and cuDNN f32's (TF32 off, which is the plain version too, timed
    once), FLOPs, bytes and bound on the CUDA cores, tile and split."""
    H, W, cin, cout = shape
    y = conv3x3(x, w, b)
    err = float((y - conv3x3_plain(x, w, b)).abs().max())
    if not err <= F32_ATOL:
        raise AssertionError(f"conv3x3 f32 at {shape}: max abs err {err}")
    repeat = bool(torch.equal(y, conv3x3(x, w, b)))
    flops, bytes_, bound_ms, bound_by = layer_bound(H, cin, cout, W, 4, PEAK_F32)
    ms = time_ms(lambda: conv3x3(x, w, b), **TIMING)
    library_ms = time_ms(library_conv(x, w, b), **TIMING)
    choice = f32_choice(H, W, cin, cout, x.device)
    print(f"H{H} W{W} {cin}->{cout}: max abs err {err:.2e}  f32 kernel {ms:.5f} ms"
          f"  bound {bound_ms:.5f} ms  cuDNN f32 {library_ms:.5f} ms  repeat {repeat}"
          f"  tile {choice}")
    return {"shape": [H, W, cin, cout], "max_abs_err": err, "bitwise_repeat": repeat,
            "flops": flops, "bytes": bytes_, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "plain_ms": library_ms, "library_ms": library_ms, "tile": choice}


def main(device=None):
    """Print and return, per f32 check shape, per f32 layer and per bf16
    layer: the error against the plain version, the kernel's, plain
    version's and library's ms, FLOPs, bound and the tile (f32: with its
    cluster split; bf16: the tensor-core tile and the ms of each of its
    stages, ops.conv3x3.STAGES)."""
    dev = resolve_device(device)
    time_ms = timer(dev)
    print(f"device: {device_name(dev)}")
    checks = [f32_row(shape, x, w, b, time_ms) for shape, x, w, b in check_inputs(dev)]
    f32_layers = [f32_row((H, H, cin, cout), x, w, b, time_ms)
                  for (H, cin, cout), x, w, b in layer_inputs(dev)]

    on_card = dev.type == "cuda"
    tiles = tc_tiles(dev) if on_card else ()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if on_card else 0
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
        tile = tiles[tc_tile(H, H, cout, tiles, sms)] if on_card else None
        stage_ms = {s: time_ms(lambda s=s: conv3x3_tc_stage(x, w, b, s), **TIMING)
                    for s in STAGES}
        print(f"{H:4d}^2 {cin:3d}->{cout:3d}: kernel {ms:7.4f} ms ({flops / ms / 1e9:6.1f} TF/s,"
              f" {bound_ms / ms:5.1%} of bound)  bound {bound_ms:7.4f} ms"
              f"  plain f32 {plain_ms:7.3f} ms  cuDNN bf16 {library_ms:7.4f} ms"
              f"  scaled err {err:.1e}  tile {tile}")
        print("        stages ms: " + "  ".join(f"{s} {t:.4f}" for s, t in stage_ms.items()))
        rows.append({"layer": [H, cin, cout], "tile": tile, "flops": flops, "bytes": bytes_,
                     "ms": ms, "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bf16_scaled_err": err, "stage_ms": stage_ms})
    return {"device": device_name(dev), "tiles": tiles, "checks": checks,
            "check_max_abs_err": [c["max_abs_err"] for c in checks], "f32_layers": f32_layers,
            "layers": rows}


if __name__ == "__main__":
    main()
