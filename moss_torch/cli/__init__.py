"""Command-line drivers: python -m moss_torch.cli.<driver> --help."""
