"""models of moss_torch (mirrors moss_tpu.models)."""
