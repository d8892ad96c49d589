"""Synthetic data streams of the port (``repro/data``)."""
