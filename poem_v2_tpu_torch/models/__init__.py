"""POEM model modules (backbone, necks, head, decoder) in PyTorch."""
