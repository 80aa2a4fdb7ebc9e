"""`nn.layers.BatchNorm`: device milliseconds a traced step of the
kernels launched inside the program's `nn.batchnorm` spans (the forward)
or `nn.batchnorm.backward` spans (autograd's thread, from the gradient
reaching the norm's output to its input's). Every BatchNorm call of a
step has one of each: the forward spans number a whole multiple of the
steps, and the backward spans as many."""

from benchmark import spans

FORWARD, BACKWARD = "nn.batchnorm", "nn.batchnorm.backward"


def read(rec):
    s, steps = rec.slice, rec.info.get("slice_steps")
    if s is None or not steps or not s.kernels:
        return None
    fwd, bwd = spans.named(s, FORWARD), spans.named(s, BACKWARD)
    if not fwd and not bwd:
        return None
    if len(fwd) % steps or len(bwd) != len(fwd):
        raise RuntimeError(f"{len(fwd)} {FORWARD} and {len(bwd)} {BACKWARD} "
                           f"spans in a slice of {steps} steps")
    k = spans.launched_in(s, {FORWARD, BACKWARD})
    return 1e3 * s.device_s(k) / steps
