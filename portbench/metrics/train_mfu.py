"""The operations a train step's mathematics needs (yardstick.
train_step_flops), times the steps of the untraced half, over its time
and the dense peak of the step's precision."""

from portbench import yardstick


def read(run):
    h = run.host
    if not h.get("steps"):
        return None
    peak = yardstick.PEAK_FLOPS[h["dtype"]]
    return 100.0 * h["steps"] * h["step_flops"] / h["wall_s"] / peak
