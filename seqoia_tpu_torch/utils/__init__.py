"""Utilities: the deterministic synthetic corpus."""
