"""Shared fixtures of the benchmark's tests: a tiny copy of the benchmark
(``tiny.py``) and the card, decided inside a fixture."""

from __future__ import annotations

import pytest
import torch

from s2a_bench.tests import tiny


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("s2a_bench_tiny"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): run on the card")
    return torch.device("cuda", 0)
