"""render of moss_torch (mirrors moss_tpu.render)."""
