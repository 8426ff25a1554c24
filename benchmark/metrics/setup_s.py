"""Seconds from the start of the process to the first timed turn: the corpus
made, the service started, the kernels built or loaded, the mix's programs
captured."""


def read(rec):
    return rec.setup_s
