"""coalescer.pack_s: FlushStats.pack_span summed over the window's
flushes, a slot."""


def read(record):
    w = record["window"]
    return w["pack_s"] / w["slots"] if w["slots"] else None
