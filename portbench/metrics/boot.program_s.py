"""boot.program_s: the program's part of set-up (host clock, ending in a
sync): the kernel build or load, the plane and coalescer, the point-cache
warm-up and the untimed slots."""


def read(record):
    return record["boot_s"]
