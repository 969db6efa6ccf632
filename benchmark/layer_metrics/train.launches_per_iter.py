"""Device kernels per traced iteration, counted in the trace."""


def read(record):
    trace = record.get("trace")
    if trace is None or not trace.n_units:
        return None
    return len(trace.kernels_in_window()) / trace.n_units
