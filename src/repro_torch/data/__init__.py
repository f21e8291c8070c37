"""Synthetic batches for the smoke tests, the examples and the training loop."""
