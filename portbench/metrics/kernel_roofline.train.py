"""The five kernels together in the traced half: the sum of each launch's
least time (the larger of its bytes over the card's bandwidth and its
operations over the peak, from the step's shapes) over the sum of their
device times in the trace."""


def read(run):
    s = run.trace_summary
    per_step = run.host.get("step_kernels")
    if s is None or not per_step:
        return None
    bound = device = 0.0
    for kernel, (launches, seconds) in per_step.items():
        n, sec = s["kernels"].get(kernel, (0, 0.0))
        if n:
            bound += n * seconds / launches
            device += sec
    return 100.0 * bound / device if device > 0 else None
