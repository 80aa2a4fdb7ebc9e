"""Networks and the hand-written CUDA kernels they run on."""
