"""Utilities: config tree, logging, TensorBoard summaries and the experiment recorder."""
