"""Measurement scripts of the port's host code (run with python -m)."""
