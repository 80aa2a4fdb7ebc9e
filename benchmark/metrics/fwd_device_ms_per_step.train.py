"""The forward (`train.state.train_step`'s `model.step`): device
milliseconds a traced step of the kernels launched inside the program's
`train.forward` span, one a step."""

from benchmark import spans


def read(rec):
    return spans.step_device_ms(rec, "train.forward")
