"""Command line (L8)."""

from pilosa_tpu_torch.cli.main import main

__all__ = ["main"]
