"""Mean time between consecutive engine calls of the traced half in which
the device has no work of theirs: from one ``engine.call``'s
``engine.download`` end (the answer on the host, so the device is done)
to the next call's ``engine.upload`` start, on the program's spans. The
scatter, the wait for requests, the linger, the gather and the next
call's padding fall in it."""

from ladder_tpu_torch.utils import profiling


def read(run):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans = recorded()["spans"]
    calls = sorted((s for s in spans if s.name == "engine.call"),
                   key=lambda s: s.start_ns)
    parts = {}
    for s in spans:
        if s.name in ("engine.upload", "engine.download"):
            parts.setdefault(s.parent, {})[s.name] = s
    gaps = []
    for a, b in zip(calls, calls[1:]):
        down = parts.get(a.id, {}).get("engine.download")
        up = parts.get(b.id, {}).get("engine.upload")
        if down is not None and up is not None:
            gaps.append(up.start_ns - down.end_ns)
    return 1e-6 * sum(gaps) / len(gaps) if gaps else None
