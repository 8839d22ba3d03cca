"""Settings of the benchmark's own tests (python -m pytest portbench/tests).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where there is none; the look for a card is made
when a test runs, never when a module is imported."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")


@pytest.fixture(scope="session")
def checkout_df64(tmp_path_factory):
    import pb_support

    return pb_support.make_checkout(tmp_path_factory.mktemp("df64"), "df64",
                                    "npb-cg-C.df64")


@pytest.fixture(scope="session")
def checkout_f64(tmp_path_factory):
    import pb_support

    return pb_support.make_checkout(tmp_path_factory.mktemp("f64"), "f64",
                                    "npb-cg-C.f64")
