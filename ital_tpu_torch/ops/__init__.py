"""Compute primitives: the RBF kernel, Cholesky updates, Genz QMC."""
