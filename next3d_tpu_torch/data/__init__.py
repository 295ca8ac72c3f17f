"""Training data."""
