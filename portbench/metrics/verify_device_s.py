"""verify_device_s: the card's busy seconds (the union of its operation
intervals, torch.profiler, CUDA activity) from the check slot's
submission to the end of its first plane program: the device decode of
the slot's partials and the RLC verify of its 4,096-lane bucket. Read in
every run; the check slot follows the window through the same program
and buckets."""


def read(record):
    t = record["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return t["busy_s"]
