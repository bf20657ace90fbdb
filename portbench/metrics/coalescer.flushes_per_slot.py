"""coalescer.flushes_per_slot: FlushStats deliveries in the window, a
slot."""


def read(record):
    w = record["window"]
    return w["flushes"] / w["slots"] if w["slots"] else None
