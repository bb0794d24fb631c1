"""Data: the synthetic multi-view dataset."""
