"""setup_s: process start to the window's first step, builds and warm-up included."""


def read(rec):
    return rec["setup_s"]
