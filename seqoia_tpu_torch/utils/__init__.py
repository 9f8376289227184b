"""Utilities: the deterministic synthetic corpus and the bench harness."""

from .corpus import make_corpus

__all__ = ["make_corpus"]
