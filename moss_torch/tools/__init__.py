"""Counterparts of the JAX package's kernel tools under tools/: each runs as
`python -m moss_torch.tools.<name>` on the GPU, or from `main(device="cpu")`
with the plain versions."""
