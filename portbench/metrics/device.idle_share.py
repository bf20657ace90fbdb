"""device.idle_share: 1 - the union of the card's operation intervals over
the traced slot's wall, % (torch.profiler, CUDA activity)."""


def read(record):
    t = record["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
