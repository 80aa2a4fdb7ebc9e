"""The benchmark of the PyTorch and CUDA port (`lossyless_tpu_torch`):
`python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1`.
"""
