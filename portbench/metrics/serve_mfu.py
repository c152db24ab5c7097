"""The operations of the real rows (padding excluded) of each engine call
in the untraced half, over the summed host time of those calls (they
return host arrays, so they end synchronised) and the float32 peak."""

from portbench import yardstick


def read(run):
    calls = run.host.get("untraced_calls")
    if not calls:
        return None
    flops = sum(n * run.host["row_flops"][path]
                for path, n, _, _, _ in calls)
    seconds = sum(c[4] for c in calls)
    return 100.0 * flops / seconds / yardstick.PEAK_FLOPS["float32"]
