"""Drivers: ``steps`` (the prefill and decode steps) and ``serve`` (the
batched serving CLI)."""
