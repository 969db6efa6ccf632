"""Seconds from the process's start to the window's first unit: imports,
the card's context, loading (or, in a fresh checkout, building) the
kernels, the inputs and the set-up's warm units."""


def read(record):
    return record["setup_s"]
