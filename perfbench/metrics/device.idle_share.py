"""device.idle_share: the share of the traced window in which no
operation ran on the device, in percent."""


def read(s):
    if s.busy_s <= 0 or s.window_s <= 0:
        return None
    return (1.0 - s.busy_s / s.window_s) * 100.0
