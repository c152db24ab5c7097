"""Mean host time from one train step's return to the next step's call:
the wait on the trainer's prefetch queue (the untraced half)."""


def read(run):
    waits = run.host.get("wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
