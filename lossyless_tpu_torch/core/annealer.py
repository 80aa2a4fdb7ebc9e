"""Hyperparameter annealing as a pure function of the step counter.

Counterpart of `lossyless_tpu/core/annealer.py`: the value is computed from
the global step, never from hidden mutable state. Values are float32, as
the JAX version returns them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Annealer:
    initial_value: float
    final_value: float
    n_steps_anneal: int
    start_step: int = 0
    default: float | None = None
    mode: str = "geometric"  # {"linear","geometric","constant"}

    def __post_init__(self):
        if self.n_steps_anneal < 0:
            object.__setattr__(self, "n_steps_anneal", -self.n_steps_anneal)
            ini, fin = self.final_value, self.initial_value
            object.__setattr__(self, "initial_value", ini)
            object.__setattr__(self, "final_value", fin)
        if self.mode not in ("linear", "geometric", "constant"):
            raise ValueError(f"unknown mode {self.mode}")

    def __call__(self, step: int) -> float:
        """Value at the integer `step`, rounded to float32."""
        f32 = np.float32
        if self.mode == "constant":
            return float(f32(self.final_value))

        default = self.initial_value if self.default is None else self.default
        t = f32(step) - f32(self.start_step)
        n = f32(self.n_steps_anneal)
        if t < 0:
            return float(f32(default))
        if t >= n:
            return float(f32(self.final_value))
        if self.mode == "geometric":
            factor = f32((self.final_value / self.initial_value) ** (1.0 / n))
            return float(f32(self.initial_value) * factor ** t)
        delta = f32((self.final_value - self.initial_value) / n)
        return float(f32(self.initial_value) + delta * t)
