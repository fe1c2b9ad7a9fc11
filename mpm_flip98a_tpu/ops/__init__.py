"""Compute ops: transfer stencils, small-matrix math, grid updates and
row binning."""
