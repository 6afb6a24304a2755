"""Drivers: one module a kind of call that the window drives (see run.py)."""
