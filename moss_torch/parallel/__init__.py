"""Training over several ranks: pixel bands and frames (port of moss_tpu/parallel/)."""
