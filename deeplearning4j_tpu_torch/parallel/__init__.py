"""Parallel serving and training (port). This slice carries only the
serving errors of ``parallel/inference.py``."""
