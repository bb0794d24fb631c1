"""Point ops, sampling and the kernel wrappers (K1-K4)."""
