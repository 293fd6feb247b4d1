"""data of moss_torch (mirrors moss_tpu.data)."""
