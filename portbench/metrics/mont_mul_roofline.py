"""mont_mul_roofline: the mont_mul kernels' share of their roofline in the traced
slot, % (portbench/trace.py roofline, portbench/peaks.py bounds)."""

from portbench import trace


def read(record):
    return trace.roofline(record["trace"], "mont_mul") if record["trace"] else None
