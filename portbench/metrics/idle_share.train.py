"""The share of the traced half of the window in which no kernel, copy or
memset ran on the device."""


def read(run):
    s = run.trace_summary
    return None if s is None else 100.0 * s["idle_share"]
