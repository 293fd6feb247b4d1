"""train of moss_torch (mirrors moss_tpu.train)."""
