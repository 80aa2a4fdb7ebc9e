"""Rate and distortion estimators and the learnable compressor."""
