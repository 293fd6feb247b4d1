"""The CUDA-core conv kernel's tile table (csrc/conv3x3.cu kF32Tiles, by tile
code): rows of 16 pixels, output channels, channels a thread. The C library
reports it only on the card; tests/test_torch_cuda.py holds this copy to it,
and tests/test_torch_conv3x3.py runs the tile picker on it."""

F32_TILES = tuple({"rows": r, "channels": c, "per_thread": p} for r, c, p in (
    (8, 64, 8), (4, 64, 8), (8, 32, 8), (4, 32, 8), (8, 16, 4), (4, 16, 4), (2, 16, 4),
    (8, 8, 4), (4, 8, 4)))


def with_threads(tiles=F32_TILES):
    """The tiles with their threads (rows x 4 strips x channels / per_thread)."""
    return tuple({**t, "threads": t["rows"] * 4 * t["channels"] // t["per_thread"]}
                 for t in tiles)
