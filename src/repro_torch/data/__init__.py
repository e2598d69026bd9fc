"""Synthetic P2HNNS data."""
