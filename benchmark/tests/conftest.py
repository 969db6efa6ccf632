"""Pytest settings of the benchmark's own tests: the `cuda` marker, the
benchmark folder and the repository root on the path, and the card fixture.

    python -m pytest benchmark/tests -q              # CPU: card tests skip
    python -m pytest benchmark/tests -q -m cuda      # on the card
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY = {
    "ppo-fishing-v1-h256.bf16": {"ppo": {"num_envs": 512, "num_steps": 64}},
    "sim-fishing-v1-escapement.batch2M": {"stepping": {"num_envs": 4096, "num_steps": 64}},
}


@pytest.fixture
def tiny():
    """A function of a cell's name -> (doc, cell, config, traffic, driver)
    with the configuration cut to a size the CPU runs in seconds (hidden
    width and everything else kept)."""
    import run as harness

    def load(name):
        doc, cell, config, traffic, driver = harness.load_cell(name)
        for group, values in TINY[name].items():
            config[group].update(values)
        return doc, cell, config, traffic, driver

    return load
