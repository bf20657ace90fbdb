"""kernels.launches_per_slot: mont_kernels.LAUNCHES summed over K1-K6 in
the window, a slot."""


def read(record):
    w = record["window"]
    return w["launches"] / w["slots"] if w["slots"] else None
