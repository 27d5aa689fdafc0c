"""Synthetic downstream datasets (numpy, bit-equal to the reference),
Dirichlet partitions and the stacked meta-training pool."""
