"""setup_s: process start to the first timed submission (host clock):
input generation, the program's boot, its warm-up and the untimed slots."""


def read(record):
    return record["setup_s"]
