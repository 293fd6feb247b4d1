"""The benchmark of moss_torch on one NVIDIA H100 (BENCHMARK.json at the root).

run.py is the entry; inputs.py makes a cell's inputs from its seed and its
files (configs/, workloads/), harness.py drives the port's Trainer, check.py
decides `correct` against the plain reference (reference/), work.py counts
the work the rooflines divide, trace.py reads the profiler's trace, and
metrics/<name>.py reads one per-layer metric. Nothing here imports jax or
moss_tpu; reference/ imports nothing of moss_torch.
"""
