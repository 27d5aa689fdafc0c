"""Synthetic downstream datasets (numpy, bit-equal to the reference)."""
