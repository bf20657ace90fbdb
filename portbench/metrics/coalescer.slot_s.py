"""coalescer.slot_s: slot_s where a cell reports it per layer: the
window's wall over the whole slots it completed, from the first slot's
submission to the last slot's last answer (host clock)."""


def read(record):
    w = record["window"]
    return w["seconds"] / w["slots"] if w["slots"] else None
