"""The JAX package's examples that need no replay buffer, as modules of the
port: ``python -m gym_fishing_tpu_torch.examples.<name> [flags] [--device
cpu]``. Each keeps its numbers in a function that `chip_smoke.py` and the
tests call, and writes its CSVs and plots only where pandas and matplotlib
are installed."""

import importlib.util


def can_write_artifacts() -> bool:
    """pandas and matplotlib are installed (the plots and CSVs need both)."""
    return all(importlib.util.find_spec(m) is not None for m in ("pandas", "matplotlib"))
