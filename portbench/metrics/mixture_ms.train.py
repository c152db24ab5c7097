"""Host time a train step spends in the mixture's log-density (the
program's ``mixture.logpdf`` spans inside a ``train.step``), summed over
the traced half and divided by its ``train.step`` spans."""

from ladder_tpu_torch.utils import profiling


def _in_step(span, by_id):
    while span.parent is not None:
        span = by_id.get(span.parent)
        if span is None:
            return False
        if span.name == "train.step":
            return True
    return False


def read(run):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans = recorded()["spans"]
    steps = sum(s.name == "train.step" for s in spans)
    if not steps:
        return None
    by_id = {s.id: s for s in spans}
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans
                      if s.name == "mixture.logpdf"
                      and _in_step(s, by_id)) / steps
