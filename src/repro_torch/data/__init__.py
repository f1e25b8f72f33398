"""Synthetic datasets of the port and the training data pipeline (batches as a
function of (seed, step), device prefetch)."""
