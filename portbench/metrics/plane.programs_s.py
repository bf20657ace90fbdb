"""plane.programs_s: SlotCryptoPlane.on_program walls (each program with
its result sync) summed over the window, a slot."""


def read(record):
    w = record["window"]
    return w["programs_s"] / w["slots"] if w["slots"] else None
