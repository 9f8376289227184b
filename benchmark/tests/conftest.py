"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

They need no card. Tests that do carry the ``card`` marker and skip here;
whether there is a card is decided in the ``card`` fixture, never while a
module is imported."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark runs on no other "
                    "device")
    return torch.device("cuda", 0)
