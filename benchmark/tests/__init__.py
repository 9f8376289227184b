"""The benchmark's tests."""
