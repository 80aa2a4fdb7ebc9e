"""The optimizer (the rates set, missing gradients filled, every AdamW
`step()`): device milliseconds a traced step of the kernels launched
inside the program's `train.optimizer` span, one a step."""

from benchmark import spans


def read(rec):
    return spans.step_device_ms(rec, "train.optimizer")
