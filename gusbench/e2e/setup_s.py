"""Process start to the first timed request (s)."""


def read(t):
    return t.setup_s
