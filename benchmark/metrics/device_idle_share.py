"""The device in the traced slice (a pass, or a few training steps): 1 -
the union of its operations' intervals over the slice's wall time."""


def read(rec):
    s = rec.slice
    if s is None or not s.device:
        return None
    return 1.0 - s.busy_s() / s.window_s
