"""Backbones: the HRNet building blocks and HRNet."""
