"""Binding (arch, shape) cells to the port's step functions."""
