"""The 95th percentile over the traced half's requests of the time each
waited in the batcher's queue: the program's ``serve.queue`` span, from
the request's submit until the worker took it into a batch."""

from ladder_tpu_torch.utils import profiling
from portbench import yardstick


def read(run):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    waits = [1e-6 * (s.end_ns - s.start_ns) for s in recorded()["spans"]
             if s.name == "serve.queue"]
    return yardstick.percentile(waits, 95) if waits else None
