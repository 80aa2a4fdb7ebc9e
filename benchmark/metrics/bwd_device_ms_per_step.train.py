"""The backward (`loss.backward()` and the data-parallel gradient
average): device milliseconds a traced step of the kernels launched
while the program's `train.backward` span is open, on any thread (autograd
launches from its device thread), one span a step."""

from benchmark import spans


def read(rec):
    return spans.step_device_ms(rec, "train.backward")
