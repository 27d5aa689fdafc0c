"""SURF configurations: ``base`` (dataclasses) and ``surf_paper`` (presets)."""
