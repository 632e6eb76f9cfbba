"""Fixtures of the benchmark's tests: whether a card is here is decided
inside a fixture, never while a module is imported."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's cells run on the "
                    "card only")
    return torch.cuda.get_device_name(0)
