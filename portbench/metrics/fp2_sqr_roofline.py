"""fp2_sqr_roofline: the fp2_sqr kernels' share of their roofline in the traced
slot, % (portbench/trace.py roofline, portbench/peaks.py bounds)."""

from portbench import trace


def read(record):
    return trace.roofline(record["trace"], "fp2_sqr") if record["trace"] else None
