"""Serving front end."""
