"""Datasets of the port (``sdss``: the paper's stripe likelihood)."""
