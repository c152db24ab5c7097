"""Mean host time of one train_step call without a synchronise (the
enqueue), over the untraced half of the window."""


def read(run):
    times = run.host.get("dispatch_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
