"""The port's image decode and write (moss_torch/data/readers.py imread,
imwrite, image_header) against imageio.v2.imread, which moss_tpu decodes
frames with, on the CPU.

  * Every PNG kind (grey at 1, 2, 4, 8 and 16 bits, grey with tRNS, RGB at
    8 and 16 bits and with tRNS, palettes at 1, 2, 4 and 8 bits and with
    tRNS, grey+alpha and RGBA at 8 and 16 bits) written three ways: by
    Pillow through imageio, by cv2, and byte by byte here for the kinds
    neither writes; JPEGs (baseline, progressive, 4:4:4 and 4:2:0, grey,
    an EXIF orientation tag) by Pillow and by cv2. readers.imread must
    equal imageio's in dtype, shape and every value.
  * A CMYK JPEG, a missing file and an undecodable one raise.
  * readers.imwrite round-trips through readers.imread and imageio alike.
  * image_header's sizes are Pillow's; FrameSpec.image_size reads them.
  * FrameSpec.load on the ZJU and MonoCap fixtures (masks as 1-bit,
    grey+alpha and JPEG files too) and colmap.frame_from_spec on Blender
    scenes (RGBA, palette, grey+alpha, whose two channels both loaders keep,
    16-bit grey) give moss_tpu's frames bit for bit.
  * The CPU driver test runs again with imageio unimportable.
"""
import importlib
import os
import struct
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from moss_tpu.data import colmap as jcolmap
from moss_tpu.data import readers as jreaders
from moss_torch.data import colmap, readers
from test_readers import _write_zju_fixture
from test_torch_colmap import _blender_scene, assert_same_frame
import test_torch_drivers
from test_torch_readers import write_monocap_fixture
from _torch_threads import two_torch_threads  # noqa: F401

cv2 = pytest.importorskip("cv2")

H, W = 11, 17


def write_png(path, samples, bit_depth, color_type, palette=None, trns=None):
    """A PNG of `samples` ((H, W * channels) ints) at any bit depth and
    colour type, filter 0 on every row, with an optional PLTE and tRNS."""
    a = np.asarray(samples)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = b""
    for row in a:
        if bit_depth < 8:
            bits = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - bit_depth:]
            line = np.packbits(bits.reshape(-1)).tobytes()
        else:
            line = row.astype(">u2" if bit_depth == 16 else np.uint8).tobytes()
        raw += b"\x00" + line

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    out = readers.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", a.shape[1] // channels, a.shape[0], bit_depth, color_type, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    with open(path, "wb") as f:
        f.write(out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _by_hand(name, path):
    rng = _rng(name)
    kind, depth = name.rstrip("t").split("_")[1], int(name.rstrip("t").split("_")[2])
    ctype, channels = {"grey": (0, 1), "rgb": (2, 3), "pal": (3, 1), "ga": (4, 2),
                       "rgba": (6, 4)}[kind]
    samples = rng.integers(0, 1 << depth, (H, W * channels))
    palette = rng.integers(0, 256, (1 << depth, 3)) if kind == "pal" else None
    trns = None
    if name.endswith("t"):
        trns = {"grey": b"\x00\x07", "rgb": b"\x00\x01\x00\x02\x00\x03",
                "pal": rng.integers(0, 256, 1 << depth, dtype=np.uint8).tobytes()}[kind]
    write_png(path, samples, depth, ctype, palette, trns)


def _by_pillow(name, path):
    rng = _rng(name)
    kind = name.split("_", 1)[1]
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    if kind == "grey8":
        imageio.imwrite(path, rgb[..., 0])
    elif kind == "rgb8":
        imageio.imwrite(path, rgb)
    elif kind == "rgba8":
        imageio.imwrite(path, rng.integers(0, 256, (H, W, 4), dtype=np.uint8))
    elif kind == "ga8":
        imageio.imwrite(path, rng.integers(0, 256, (H, W, 2), dtype=np.uint8))
    elif kind == "bit1":
        Image.fromarray(rng.integers(0, 2, (H, W)).astype(bool)).save(path)  # mode "1"
    elif kind == "grey16":
        imageio.imwrite(path, rng.integers(0, 65536, (H, W), dtype=np.uint16))
    elif kind.startswith("pal"):
        im = Image.fromarray(rng.integers(0, 16, (H, W), dtype=np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 48).tolist())
        im.save(path, **({"transparency": 3} if kind == "pal4t" else {}))
    elif kind == "baseline.jpg":
        imageio.imwrite(path, rgb, quality=90)
    elif kind == "progressive.jpg":
        imageio.imwrite(path, rgb, quality=90, progressive=True)
    elif kind == "444.jpg":
        Image.fromarray(rgb).save(path, quality=95, subsampling=0)
    elif kind == "grey.jpg":
        imageio.imwrite(path, rgb[..., 0])
    elif kind == "exif.jpg":
        im = Image.fromarray(rgb)
        exif = im.getexif()
        exif[0x0112] = 6  # orientation: rotate 90
        im.save(path, exif=exif)
    else:
        raise KeyError(kind)


def _by_cv2(name, path):
    rng = _rng(name)
    kind = name.split("_", 1)[1]
    bgr = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    params = []
    if kind == "grey8":
        img = bgr[..., 0]
    elif kind == "bgr8":
        img = bgr
    elif kind == "bgra8":
        img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    elif kind == "bilevel":
        img, params = bgr[..., 0], [cv2.IMWRITE_PNG_BILEVEL, 1]
    elif kind in ("grey16", "bgr16", "bgra16"):
        img = rng.integers(0, 65536, (H, W, {"grey16": 1, "bgr16": 3, "bgra16": 4}[kind]),
                           dtype=np.uint16).squeeze(-1 if kind == "grey16" else ())
    elif kind.endswith(".jpg"):
        img = bgr[..., 0] if kind == "grey.jpg" else bgr
        params = {"baseline.jpg": [cv2.IMWRITE_JPEG_QUALITY, 90],
                  "progressive.jpg": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                  "444.jpg": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
                  "420.jpg": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
                  "grey.jpg": []}[kind]
    else:
        raise KeyError(kind)
    assert cv2.imwrite(path, np.ascontiguousarray(img), params)


BY_HAND = ["hand_grey_1", "hand_grey_2", "hand_grey_4", "hand_grey_8", "hand_grey_16",
           "hand_grey_8t", "hand_rgb_8", "hand_rgb_16", "hand_rgb_8t", "hand_pal_1",
           "hand_pal_2", "hand_pal_4", "hand_pal_8", "hand_pal_8t", "hand_ga_8", "hand_ga_16",
           "hand_rgba_8", "hand_rgba_16"]
BY_PILLOW = ["pillow_grey8", "pillow_rgb8", "pillow_rgba8", "pillow_ga8", "pillow_bit1",
             "pillow_grey16", "pillow_pal4", "pillow_pal4t", "pillow_baseline.jpg",
             "pillow_progressive.jpg", "pillow_444.jpg", "pillow_grey.jpg", "pillow_exif.jpg"]
BY_CV2 = ["cv2_grey8", "cv2_bgr8", "cv2_bgra8", "cv2_bilevel", "cv2_grey16", "cv2_bgr16",
          "cv2_bgra16", "cv2_baseline.jpg", "cv2_progressive.jpg", "cv2_444.jpg", "cv2_420.jpg",
          "cv2_grey.jpg"]
WRITERS = {"hand": _by_hand, "pillow": _by_pillow, "cv2": _by_cv2}


def _write(tmp_path, name):
    path = str(tmp_path / (name if name.endswith(".jpg") else name + ".png"))
    WRITERS[name.split("_")[0]](name, path)
    return path


@pytest.mark.parametrize("name", BY_HAND + BY_PILLOW + BY_CV2)
def test_imread_is_imageios(tmp_path, name):
    path = _write(tmp_path, name)
    ref, got = imageio.imread(path), readers.imread(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.flags.c_contiguous


def test_the_formats_where_the_decoders_differ_are_covered(tmp_path):
    """The traps the helper handles: 1-bit grey is bool under imageio and
    0/255 under cv2, grey+alpha is expanded to four channels by cv2, RGB
    with tRNS gains an alpha under cv2, 16-bit RGB stays 16-bit under cv2,
    an EXIF orientation is applied by cv2's default flags."""
    raw = {n: cv2.imread(_write(tmp_path, n), cv2.IMREAD_UNCHANGED)
           for n in ("pillow_bit1", "hand_ga_8", "hand_rgb_8t", "hand_rgb_16")}
    assert raw["pillow_bit1"].dtype == np.uint8 and raw["pillow_bit1"].max() == 255
    assert raw["hand_ga_8"].shape[-1] == 4 and raw["hand_rgb_8t"].shape[-1] == 4
    assert raw["hand_rgb_16"].dtype == np.uint16
    exif = _write(tmp_path, "pillow_exif.jpg")
    assert cv2.imread(exif).shape[:2] == (W, H)  # IMREAD_COLOR rotates
    assert readers.imread(exif).shape[:2] == imageio.imread(exif).shape[:2] == (H, W)


def test_imread_raises_on_cmyk_missing_and_undecodable_files(tmp_path):
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(np.zeros((H, W, 4), np.uint8), "CMYK").save(cmyk)
    with pytest.raises(ValueError, match="CMYK"):
        readers.imread(cmyk)
    with pytest.raises(FileNotFoundError):
        readers.imread(str(tmp_path / "absent.png"))
    bad = tmp_path / "bad.png"
    bad.write_bytes(readers.PNG_SIGNATURE + b"not a png")
    with pytest.raises(ValueError, match="cannot decode"):
        readers.imread(str(bad))


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "rgba8", "grey16", "bool"])
def test_imwrite_round_trips(tmp_path, kind):
    rng = _rng(kind)
    img = {"grey8": rng.integers(0, 256, (H, W), dtype=np.uint8),
           "rgb8": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
           "rgba8": rng.integers(0, 256, (H, W, 4), dtype=np.uint8),
           "grey16": rng.integers(0, 65536, (H, W), dtype=np.uint16),
           "bool": rng.integers(0, 2, (H, W)).astype(bool)}[kind]
    path = str(tmp_path / "out.png")
    readers.imwrite(path, img)
    for back in (readers.imread(path), imageio.imread(path)):
        assert back.dtype == img.dtype and back.shape == img.shape
        np.testing.assert_array_equal(back, img)
    assert readers.image_header(open(path, "rb").read())["format"] == "png"


def test_imwrite_refuses_what_it_cannot_round_trip(tmp_path):
    for img in (np.zeros((H, W, 2), np.uint8), np.zeros((H, W, 3), np.uint16),
                np.zeros((H, W), np.float32)):
        with pytest.raises(ValueError):
            readers.imwrite(str(tmp_path / "x.png"), img)


@pytest.mark.parametrize("name", ["hand_rgb_8", "pillow_baseline.jpg", "pillow_exif.jpg",
                                  "cv2_progressive.jpg", "cv2_grey.jpg"])
def test_image_header_sizes_are_pillows(tmp_path, name):
    path = _write(tmp_path, name)
    head = readers.image_header(open(path, "rb").read())
    with Image.open(path) as im:
        assert (head["width"], head["height"]) == im.size
    assert head["format"] == ("jpeg" if name.endswith(".jpg") else "png")
    assert readers.image_header(b"GIF89a")["format"] is None


# ---- whole frames: the port's loaders bitwise moss_tpu's -----------------------


def _rewrite_masks(root, how):
    """Every mask PNG under root re-encoded: "bit1" (1-bit grey, the values
    != 0 set), "ga" (grey+alpha) or "jpg" (a JPEG at the same path)."""
    for dirpath, _, files in os.walk(os.path.join(root, "mask")):
        for f in files:
            path = os.path.join(dirpath, f)
            m = imageio.imread(path)
            if how == "bit1":
                Image.fromarray(m != 0).save(path)
            elif how == "ga":
                imageio.imwrite(path, np.stack([m, np.full_like(m, 200)], -1))
            elif how == "jpg":  # JPEG bytes under the .png name
                Image.fromarray(m).save(path, format="JPEG")


def _assert_frames_equal(frame, jframe):
    for f in ("image", "bkgd_mask", "bound_mask"):
        np.testing.assert_array_equal(getattr(frame, f).numpy(), np.asarray(getattr(jframe, f)),
                                      err_msg=f)


@pytest.mark.parametrize("dataset,masks", [("zju", "png"), ("zju", "bit1"), ("zju", "ga"),
                                           ("olek", "png"), ("olek", "bit1"), ("lan", "jpg")])
def test_frame_spec_load_is_moss_tpus(tmp_path, dataset, masks):
    if dataset == "zju":
        root = str(tmp_path / "my_377")
        _write_zju_fixture(root, n_frames=60)
    else:
        root = str(tmp_path / {"olek": "olek_images0812", "lan": "lan_images620"}[dataset])
        write_monocap_fixture(root)
    if masks != "png":
        _rewrite_masks(root, masks)
    for split in ("train", "test"):
        _, specs = readers.detect_and_read(root, split, device="cpu")
        _, jspecs = jreaders.detect_and_read(root, split)
        for s, js in list(zip(specs, jspecs))[:3]:
            _assert_frames_equal(s.load(None, "cpu"), js.load(None))
        assert specs[0].image_size() == jspecs[0].image_size()


@pytest.mark.parametrize("kind", ["rgba", "palette", "grey_alpha", "grey16"])
@pytest.mark.parametrize("white", [False, True], ids=["black", "white"])
def test_frame_from_spec_is_moss_tpus(tmp_path, kind, white):
    _blender_scene(str(tmp_path))
    spec = colmap.read_blender_scene(str(tmp_path), "train", white)[1]
    rng = _rng(kind)
    if kind == "palette":
        im = Image.fromarray(rng.integers(0, 16, (24, 32), dtype=np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 48).tolist())
        im.save(spec["image_path"], transparency=5)
    elif kind == "grey_alpha":
        imageio.imwrite(spec["image_path"], rng.integers(0, 256, (24, 32, 2), dtype=np.uint8))
    elif kind == "grey16":
        imageio.imwrite(spec["image_path"], rng.integers(0, 256, (24, 32), dtype=np.uint16))
    assert_same_frame(colmap.frame_from_spec(spec, device="cpu"), jcolmap.frame_from_spec(spec))


def test_drivers_run_without_imageio(tmp_path, capsys, monkeypatch):
    """test_train_then_render_cli with imageio unimportable: nothing in the
    port's train_zju -> render_zju path (decode, PNG writes) needs it. The
    fixture writer holds imageio from before, its plugins loaded here."""
    for name in ("warm.jpg", "warm.png"):
        imageio.imwrite(str(tmp_path / name), np.zeros((8, 8, 3), np.uint8))
    with pytest.MonkeyPatch.context() as mp:
        for name in ("imageio", "imageio.v2", "imageio.v3"):
            mp.setitem(sys.modules, name, None)
        with pytest.raises(ImportError):
            importlib.import_module("imageio.v2")
        test_torch_drivers.test_train_then_render_cli(tmp_path, capsys, monkeypatch)
