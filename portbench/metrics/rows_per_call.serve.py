"""Rows per engine call over the untraced half: the batcher's own counters
(Batcher.stats), rows over batches."""


def read(run):
    pair = run.host.get("batcher")
    if not pair:
        return None
    before, after = pair
    batches = after["batches"] - before["batches"]
    return (after["rows"] - before["rows"]) / batches if batches else None
