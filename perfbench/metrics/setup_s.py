"""setup_s: process start to the end of the warm-up (set-up, table
builds, the first calls' planning and compilation)."""


def read(r):
    return r.setup_s
