"""The share of the rows the engine ran in the traced half that were
padding: the program's counters ``engine.pad_rows`` over ``engine.rows``
+ ``engine.pad_rows``, in %."""

from ladder_tpu_torch.utils import profiling


def read(run):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    counters = recorded()["counters"]
    rows = counters.get("engine.rows", 0)
    pad = counters.get("engine.pad_rows", 0)
    return 100.0 * pad / (rows + pad) if rows + pad else None
