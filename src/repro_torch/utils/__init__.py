"""Process-level helpers: bounded caches and device placement."""
