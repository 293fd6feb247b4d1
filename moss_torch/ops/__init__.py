"""ops of moss_torch (mirrors moss_tpu.ops)."""
