"""Communication topologies (numpy, bit-equal to the reference)."""
