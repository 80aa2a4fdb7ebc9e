"""Hub usage demo on the PyTorch/CUDA port.

The flow of `examples/hub_demo.py` on `lossyless_tpu_torch`:

    comp = clip_compressor_b005()        # published factorized_rate weights
    comp.compress_dataset(batches, 'stl10.bin', label_file='labels.npy')
    z, y = comp.decompress_dataset('stl10.bin', 'labels.npy')

The tower is seeded random unless `load_pretrained(clip_state_dict=...)`
is given OpenAI's state dict; the images are synthetic STL10-shaped
uint8. The rate weights are the published `beta*_factorized_rate.pt`
files (`hub/load_reference.py`): without them `clip_compressor_b005`
raises `FileNotFoundError`.

Run: `python examples/hub_demo_torch.py` (on the card; pass
`device="cpu"` to `main` for the CPU).
"""

import tempfile
from pathlib import Path

import numpy as np

from lossyless_tpu_torch.hub import clip_compressor_b005


def main(n_images=64, batch=16, device=None):
    # raw STL10-native 96 px uint8 goes to the card; resize and normalize
    # run there
    comp = clip_compressor_b005(raw_input_hw=(96, 96), device=device)

    rng = np.random.default_rng(0)
    xs = rng.integers(0, 256, (n_images, 96, 96, 3), dtype=np.uint8)
    ys = rng.integers(0, 10, n_images)
    batches = ((xs[i:i + batch], ys[i:i + batch])
               for i in range(0, n_images, batch))

    with tempfile.TemporaryDirectory() as td:
        f, lab = Path(td) / "demo.bin", Path(td) / "labels.npy"
        rate, enc_speed = comp.compress_dataset(batches, f, label_file=lab)
        z, y = comp.decompress_dataset(f, lab)

    if z.shape != (n_images, 512) or not (y == ys).all():
        raise AssertionError(f"round trip gave z {z.shape}, labels "
                             f"{'equal' if (y == ys).all() else 'unequal'}")
    print(f"round-trip OK: {rate:.1f} bits/img, z {z.shape}")
    return rate, z, y


if __name__ == "__main__":
    main()
