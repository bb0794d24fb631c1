"""The POEM generalized head."""
