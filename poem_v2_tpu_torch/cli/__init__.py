"""Command-line entry points: ``python -m poem_v2_tpu_torch.cli.train`` and ``.eval``."""
