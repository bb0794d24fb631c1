"""Backbones: ResNet (with the HRNet building blocks), HRNet and the hourglass."""
