"""Process start to the first call of the window, in seconds."""


def read(rec):
    return rec.setup_s
