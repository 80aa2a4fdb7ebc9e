"""Minimal compressor training on the PyTorch/CUDA port.

The flow of `examples/minimal_code.py` (the paper's Appendix E.7
protocol) on `lossyless_tpu_torch`, in four steps that `main` calls in
turn:

1. `featurize`: (N, d) features of a frozen pretrained encoder (CLIP in
   the paper); here synthetic CLIP-like features, for a self-contained
   run;
2. `train`: a factorized entropy bottleneck on those features with the
   lossy_Z distortion, batches drawn on the device
   (`FeaturesDataset.device_sampler`), the likelihood and its backward on
   the hand-written kernel K3 (`rate.eb_use_pallas`);
3. `code`: compress another dataset's features to rANS bitstreams and
   decompress them;
4. `probe`: a LinearSVC on the raw and on the decompressed features
   (scikit-learn) -- the accuracies should match at ~1.5-2 kbit/sample.

Run: `python examples/minimal_code_torch.py` (on the card; pass
`device="cpu"` to `main` for the CPU).
"""

import numpy as np
import torch

from lossyless_tpu_torch.analysis.linear_eval import z_linear_eval
from lossyless_tpu_torch.compressors.compressor import (CompressorConfig,
                                                        EncoderConfig,
                                                        LearnableCompressor,
                                                        LossConfig,
                                                        OnlineEvalConfig)
from lossyless_tpu_torch.compressors.distortions import DistortionConfig
from lossyless_tpu_torch.compressors.rates import FactorizedCoder, RateConfig
from lossyless_tpu_torch.core.device import resolve_device
from lossyless_tpu_torch.data.features import FeaturesDataset
from lossyless_tpu_torch.train.state import (OptimConfig, TrainState,
                                             make_generative_epoch)

STEPS_PER_EPOCH = 100
BATCH = 256


def synthetic_clip_features(n, d=64, n_classes=10, seed=0):
    """Stand-in for CLIP embeddings: class-clustered unit-norm vectors."""
    centers = np.random.default_rng(42).normal(0, 1, (n_classes, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    z = centers[y] + rng.normal(0, 0.25, (n, d))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return z.astype(np.float32), y


def featurize(d=64, n_train=4000, n_test=1000):
    """Step 1: (z_train, y_train, z_test, y_test)."""
    z_tr, y_tr = synthetic_clip_features(n_train, d)
    z_te, y_te = synthetic_clip_features(n_test, d, seed=1)
    return z_tr, y_tr, z_te, y_te


def setup(z_tr, y_tr, beta=0.01, device=None,
          steps_per_epoch=STEPS_PER_EPOCH, batch=BATCH, eb_use_pallas=True):
    """Step 2's set-up: the entropy bottleneck on the features
    (`bottleneck_clip_lossyZ`), its train state and the epoch function
    that draws its batches on the device. `eb_use_pallas=False` runs the
    likelihood on its plain version instead of K3."""
    device = resolve_device(device)
    d = z_tr.shape[1]
    cfg = CompressorConfig(
        encoder=EncoderConfig(arch="identity", z_dim=d),
        rate=RateConfig(mode="H_factorized", eb_filters=(3, 3, 3, 3),
                        eb_use_pallas=eb_use_pallas),
        distortion=DistortionConfig(mode="lossy_Z", p_norm=1),
        online=OnlineEvalConfig(is_online=False),
        loss=LossConfig(beta=beta, beta_anneal="constant"),
        in_shape=(d,), target_shape=10, aux_shape=(d,),
    )
    model = LearnableCompressor(
        cfg, generator=torch.Generator().manual_seed(0)).to(device)
    state = TrainState.create(model, main=OptimConfig(lr=1e-3),
                              coder=OptimConfig(lr=1e-3))
    ds = FeaturesDataset(z_tr, y_tr, additional_target="target")
    epoch_fn = make_generative_epoch(ds.device_sampler(batch, device),
                                     steps_per_epoch)
    return state, epoch_fn


def run_epochs(state: TrainState, epoch_fn, n_epochs=20) -> TrainState:
    """Step 2's loop: `n_epochs` epochs of `epoch_fn`, epoch e drawing
    from seed e."""
    logs = None
    for e in range(n_epochs):
        state, logs = epoch_fn(state, e + 1)
    print(f"trained: loss={float(logs['loss'][-1]):.3f} "
          f"rate={float(logs['rate'][-1]):.2f} bits")
    return state


def train(z_tr, y_tr, beta=0.01, n_epochs=20, device=None,
          steps_per_epoch=STEPS_PER_EPOCH, batch=BATCH) -> TrainState:
    """Step 2: the entropy bottleneck trained on the features; returns
    the train state."""
    state, epoch_fn = setup(z_tr, y_tr, beta=beta, device=device,
                            steps_per_epoch=steps_per_epoch, batch=batch)
    return run_epochs(state, epoch_fn, n_epochs)


def code(state: TrainState, z):
    """Step 3: rANS bitstreams of the features `z` and their decoding.
    Returns (coder, streams, decoded features)."""
    coder = FactorizedCoder.from_module(state.model.rate_estimator)
    streams = coder.compress(z)
    return coder, streams, coder.decompress(streams)


def dequantize(coder: FactorizedCoder, z) -> np.ndarray:
    """What decoding must give back: the features quantized and mapped
    back without the entropy coder."""
    z_in = coder.process_in(z)
    return coder.process_out(np.round(z_in - coder.medians[None])
                             + coder.medians[None])


def probe(z_tr, y_tr, z_te, y_te, zc_tr, zc_te):
    """Step 4: LinearSVC accuracy on raw and on decompressed features."""
    base = z_linear_eval(z_tr, y_tr, z_te, y_te, fixed_C=0.1)
    comp = z_linear_eval(zc_tr, y_tr, zc_te, y_te, fixed_C=0.1)
    print(f"probe acc: raw={base['acc']:.4f} compressed={comp['acc']:.4f}")
    return base["acc"], comp["acc"]


def main(d=64, beta=0.01, n_epochs=20, device=None):
    z_tr, y_tr, z_te, y_te = featurize(d)
    state = train(z_tr, y_tr, beta=beta, n_epochs=n_epochs, device=device)
    _, _, zc_tr = code(state, z_tr)
    _, s_te, zc_te = code(state, z_te)
    bits = 8 * np.mean([len(s) for s in s_te])
    print(f"coded rate: {bits:.1f} bits/sample")
    base_acc, comp_acc = probe(z_tr, y_tr, z_te, y_te, zc_tr, zc_te)
    return bits, base_acc, comp_acc


if __name__ == "__main__":
    main()
