"""Serving steps over the model zoo (port of `repro.launch`, serving
steps only)."""
