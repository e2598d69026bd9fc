"""Synthetic data: P2HNNS point sets and queries, LM token streams."""
