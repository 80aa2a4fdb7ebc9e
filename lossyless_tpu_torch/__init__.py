"""lossyless_tpu_torch — the PyTorch/CUDA port of `lossyless_tpu`.

A second package beside the JAX one, laid out like it (`core/`, `coding/`,
`nn/`, `data/`, `hub/`) so each module has an obvious counterpart. It
imports torch, numpy and PIL, never JAX nor anything of `lossyless_tpu`.

The attention kernels of the CLIP tower are hand-written CUDA for Hopper
(`nn/csrc/attention.cu`), built with nvcc at first use into
`lossyless_tpu_torch/_build/` (`nn/_build.py`), as is the host rANS codec.
Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
