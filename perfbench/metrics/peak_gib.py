"""peak_gib: the device memory the run's allocator held at its peak, over
set-up and window (reset at process start), less what the harness itself
holds for the whole run (the kept steps' buffers, its index tensors and
the grid-point update), which no deployment holds."""


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None
