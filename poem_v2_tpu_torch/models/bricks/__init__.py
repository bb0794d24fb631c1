"""Attention and point-transformer bricks of the decoder."""
