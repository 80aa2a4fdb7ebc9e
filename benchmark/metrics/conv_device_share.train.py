"""`nn.resnet`: device time of the kernels launched inside a convolution
operator (forward or backward) over the device's busy time in the traced
steps."""


def read(rec):
    s = rec.slice
    if s is None or not s.device:
        return None
    conv = s.launched_under(r"conv")
    return s.device_s(conv) / s.busy_s() if conv else None
