"""Mean time the trainer's loop took to hand a train step its batch (the
program's ``train.batch_wait`` spans whose step then ran: a
``train.step`` of the same index on the same thread), over the traced
half, in which a running profiler arms the program's spans."""

from ladder_tpu_torch.utils import profiling


def read(run):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans = recorded()["spans"]
    ran = {(s.thread, s.attrs.get("step")) for s in spans
           if s.name == "train.step"}
    waits = [s.end_ns - s.start_ns for s in spans
             if s.name == "train.batch_wait"
             and (s.thread, s.attrs.get("step")) in ran]
    return 1e-6 * sum(waits) / len(waits) if waits else None
