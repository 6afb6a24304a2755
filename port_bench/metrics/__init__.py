"""Metric readers: metrics/<name>.py holds read(ctx) for the metric of that
name in BENCHMARK.json, or, where there is no such file, metrics/<the name
up to its first dot>.py (a quantity split by cell, such as
device_idle_pct.near, reads with device_idle_pct.py). A reader returns a
number or None (nothing to read)."""
