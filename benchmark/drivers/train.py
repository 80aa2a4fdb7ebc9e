"""Training: the fused epochs of `pipeline.run.run_featurizer_stage`
(`train.state.make_generative_epoch` over the dataset's `ImageSampler`),
one epoch after another.

Configuration keys: `preset` and `overrides` (the program's recipe, as
`pipeline.config` names them) and `reference` (the recipe's numbers for
the plain reference: beta, the temperature's bound, the annealing steps,
each optimizer group's rate, weight decay and decay factor). Traffic
parameters: `dataset` (the image spec the program knows the data by),
`images` (how many the benchmark makes from the seed), `slice` (the
traced epoch's first profiled step and how many steps it profiles).

Set-up builds the train state as the pipeline does, loads the weights the
benchmark made from the seed, and runs the first epoch, which warms every
shape. The window runs whole epochs (each ends in the epoch's one
readback of its logs) until `seconds` have gone by: `train_img_per_s` is
every row of every step over the window's whole time. The traced slice
is four steps of one more epoch (`slice`), between two synchronisations.
`closing` runs one more epoch, untimed.

The check follows the first three steps of two epochs: set-up's, from
the seeded weights, and `closing`'s, from the state the window left (its
parameters, AdamW's moments and counts, the global step). Every epoch
runs one path: the sampler handed to the epoch records a followed step's
indices and augmentation draws through a call-through of its `build`,
and a forward hook on the rate estimator reads the noise it added (its
output against its input); nothing of the program is replaced.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from benchmark import seeded, trace
from benchmark.reference import bince as ref_bince


class Session:
    def __init__(self, cell, seed: int, device: str):
        self.cfg, self.tr, self.limits = cell.config, cell.traffic, cell.limits
        self.seed, self.device = seed, torch.device(device)
        self.attempted = self.failed = 0
        self.info: dict = {}
        self.stage = self.slicing = self.late = None

    # -- the program --------------------------------------------------------

    def setup(self):
        from lossyless_tpu_torch.data.images import ImageDataset
        from lossyless_tpu_torch.pipeline import config as pcfg
        from lossyless_tpu_torch.pipeline.run import build_state
        from lossyless_tpu_torch.train.state import make_generative_epoch

        cfg = pcfg.apply_overrides(pcfg.preset(self.cfg["preset"]),
                                   self.cfg["overrides"])
        cfg.trainer = dataclasses.replace(cfg.trainer,
                                          seed=self.seed & seeded.MASK)
        cfg = pcfg.apply_precision(cfg)
        g = seeded.generator(self.seed, self.device)
        ds = ImageDataset(name=self.tr["dataset"], split="train",
                          additional_target="equiv_x", synthetic=True,
                          synthetic_n=1, val_fraction=0.0)
        h, w, _ = ds.spec.shape
        n = self.tr["images"]
        self.images = seeded.images(n, h, w, g, self.device)
        self.labels = torch.randint(0, ds.spec.n_classes, (n,), generator=g,
                                    device=self.device).cpu().numpy()
        ds.data, ds.targets = self.images, self.labels
        cfg.in_shape = ds.spec.shape
        cfg.target_shape = ds.spec.n_classes
        cfg.aux_shape = ds.spec.shape
        self.batch = cfg.data_feat.batch_size
        self.steps_per_epoch = n // self.batch
        self.total_steps = self.steps_per_epoch * cfg.data_feat.n_epochs
        self.state = build_state(cfg, self.total_steps, self.steps_per_epoch,
                                 self.device)
        self.names = {p: k for k, p in self.state.model.named_parameters()}
        self.init = self.initial_weights(g)
        self.state.model.load_state_dict(self.init)
        self.sampler = ds.device_sampler(self.batch)
        self.epoch_fn = make_generative_epoch(self._sample,
                                              self.steps_per_epoch)
        self.epoch_seed = cfg.trainer.seed
        self.epochs = self.calls = 0
        self._install_recorders()
        self.first = self._followed_epoch(
            {k: self.init[k] for k in self.names.values()}, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def initial_weights(self, g) -> dict:
        """Every tensor of the model's state made from the seed: convolution
        kernels N(0, 2/fan_out), dense kernels N(0, 1/fan_in), dense biases
        N(0, 0.02^2), BatchNorm's scale 1 and bias 0 (running mean 0,
        variance 1), the affine 0, the factorized prior as
        `seeded.factorized_prior`, the temperature's log 1/0.07."""
        sd = self.state.model.state_dict()
        normal = {}
        for k, v in sd.items():
            if k.endswith(".kernel") and v.dim() == 4:
                normal[k] = (tuple(v.shape), (2.0 / (v.shape[0] * v.shape[2]
                                                     * v.shape[3])) ** 0.5)
            elif k.endswith(".kernel"):
                normal[k] = (tuple(v.shape), v.shape[0] ** -0.5)
            elif k.endswith(".bias") and ".Dense_" in k:
                normal[k] = (tuple(v.shape), 0.02)
        out = seeded.normal_leaves({k: s for k, (s, _) in normal.items()},
                                   {k: sd_ for k, (_, sd_) in normal.items()},
                                   g, self.device)
        e = "rate_estimator.entropy_bottleneck."
        z = sd[e + "quantiles"].shape[0]
        filters = tuple(sd[f"{e}matrix{i}"].shape[1]
                        for i in range(3) if f"{e}matrix{i}" in sd)
        prior = seeded.factorized_prior(z, filters, 10.0, g, self.device)
        for k, v in sd.items():
            if k in out:
                continue
            leaf = k.rsplit(".", 1)[-1]
            if k.startswith(e):
                t = torch.from_numpy(prior[leaf])
            elif k.endswith("logit_scale"):
                t = torch.tensor(math.log(1 / 0.07))
            elif leaf in ("scale", "var"):
                t = torch.ones(v.shape)
            else:
                t = torch.zeros(v.shape)
            out[k] = t.to(self.device, v.dtype)
        return out

    # -- following three steps of an epoch ---------------------------------

    def _install_recorders(self):
        """A call-through of the sampler's `build` and a forward hook on the
        rate estimator, in place for every epoch; they record only while
        an epoch is followed (`self.stage`)."""
        build = self.sampler.build

        def recording_build(idx, x_draw=None, aux_draw=None, label_draw=None):
            st = self.stage
            if st is not None and st["k"] <= 3:
                st["draws"].append((idx.clone(), _copy(x_draw),
                                    _copy(aux_draw)))
            return build(idx, x_draw, aux_draw, label_draw)

        self.sampler.build = recording_build
        rate = self.state.model.rate_estimator
        leaves = dict(rate.named_parameters())
        self._affine = (leaves["affine.biasing"], leaves["affine.scaling"])
        rate.register_forward_hook(self._noise_hook, with_kwargs=True)

    def _noise_hook(self, module, args, kwargs, output):
        """The noise the rate estimator added: its output z_hat and its
        input z, both mapped in by the affine, (z_hat + b) e^s - (z + b)
        e^s."""
        st = self.stage
        if st is None or not 1 <= st["k"] <= 3 or not kwargs.get("training"):
            return None
        z = args[0] if args else kwargs["z"]
        with torch.no_grad():
            b, s = (t.detach().float() for t in self._affine)
            e = torch.exp(s)
            noise = (output[0].detach().float() + b) * e \
                - (z.detach().float() + b) * e
        st["noise"][st["k"] - 1].append(noise)
        return None

    def _moments(self) -> tuple[dict, dict, dict]:
        """AdamW's first and second moments and update counts, a leaf."""
        m, v, count = {}, {}, {}
        for opt, _ in self.state.optimizers.values():
            for group in opt.param_groups:
                for p in group["params"]:
                    st, k = opt.state.get(p, {}), self.names[p]
                    m[k] = st["exp_avg"].clone() if "exp_avg" in st \
                        else torch.zeros_like(p)
                    v[k] = st["exp_avg_sq"].clone() if "exp_avg_sq" in st \
                        else torch.zeros_like(p)
                    count[k] = int(st["step"]) if "step" in st else 0
        return m, v, count

    def _params(self) -> dict:
        return {k: p.detach().clone() for p, k in self.names.items()}

    def _followed_epoch(self, params0: dict, start: dict | None) -> dict:
        """Run one epoch; record what the reference needs to follow its
        first three steps from `params0` and `start` (see
        `reference.bince.follow`)."""
        self.stage = {"params0": params0, "start": start, "k": 0,
                      "draws": [], "noise": [[], [], []]}
        try:
            logs = self._epoch()
        finally:
            st, self.stage = self.stage, None
        st["logs"] = [{k: float(logs[k][t])
                       for k in ("loss", "rate", "distortion")}
                      for t in range(3)]
        return st

    def _sample(self, generator):
        from torch.profiler import record_function

        self.calls += 1
        st = self.stage
        if st is not None:
            st["k"] += 1
            if st["k"] == 2:      # after the first step: its moments
                st["moment1"] = self._moments()[0]
            elif st["k"] == 4:    # after the third: the parameters
                st["params3"] = self._params()
        if self.slicing is not None:
            self._slice_step()
        with record_function("bench.sampler"):
            return self.sampler(generator)

    # -- the window ---------------------------------------------------------

    def _slice_step(self):
        """Open the profiler before the slice's first step of the traced
        epoch and close it after its last; count K3's launches between."""
        from lossyless_tpu_torch.coding import eb_kernel

        first, n = self.tr["slice"]
        k = self.calls - self.slicing["first_call"]
        if k == first:
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.slicing["launches"] = dict(eb_kernel.LAUNCHES)
            self.slicing["cm"] = trace.profiled(self.slicing["holder"])
            self.slicing["cm"].__enter__()
        elif k == first + n:
            self.slicing["cm"].__exit__(None, None, None)
            self.slicing["cm"] = None
            before = self.slicing["launches"]
            self.info["slice_launches"] = {
                k: v - before.get(k, 0) for k, v in eb_kernel.LAUNCHES.items()}

    def _epoch(self) -> dict:
        _, logs = self.epoch_fn(self.state, self.epoch_seed + self.epochs)
        self.epochs += 1
        return logs

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        steps, epoch_s = 0, []
        while steps == 0 or time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            self._epoch()
            epoch_s.append(time.perf_counter() - t)
            steps += self.steps_per_epoch
        elapsed = time.perf_counter() - t0
        self.attempted = steps * self.batch
        self.info.update(window_steps=steps, window_s=elapsed,
                         batch=self.batch, epoch_s=epoch_s)
        return {"train_img_per_s": steps * self.batch / elapsed}

    def trace(self):
        self.slicing = {"holder": {}, "cm": None, "first_call": self.calls}
        try:
            self._epoch()
        finally:
            if self.slicing["cm"] is not None:
                self.slicing["cm"].__exit__(None, None, None)
            holder, self.slicing = self.slicing["holder"], None
        self.info["slice_steps"] = self.tr["slice"][1]
        self.attempted += self.steps_per_epoch * self.batch
        return holder["slice"]

    def closing(self):
        """One more epoch, untimed, whose first three steps the check
        follows from the state the window left."""
        m, v, count = self._moments()
        start = {"step": self.state.step, "m": m, "v": v, "count": count}
        self.late = self._followed_epoch(self._params(), start)
        self.info["late_step"] = start["step"]

    def free(self):
        del self.state, self.epoch_fn, self.sampler, self._affine, self.names
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def _stages(self) -> list:
        if self.late is None:
            raise RuntimeError("the check follows the epoch after the "
                               "window: call closing() first")
        return [("first", self.first), ("late", self.late)]

    def _batches(self, st: dict) -> list:
        """A followed epoch's first three steps' inputs as the reference
        takes them."""
        out = []
        for t in range(3):
            idx, d_x, d_pos = st["draws"][t]
            i = idx.cpu().numpy()
            raw = torch.from_numpy(self.images[i]).to(self.device)
            y = torch.from_numpy(self.labels[i]).to(self.device)
            noise = torch.cat(st["noise"][t])
            if noise.shape[0] != 2 * len(i):
                raise RuntimeError(f"step {t}: noise of {noise.shape[0]} rows "
                                   f"recorded for two views of {len(i)}")
            out.append((raw, y, (d_x, d_pos),
                        (noise[:len(i)], noise[len(i):])))
        return out

    def _hp(self) -> dict:
        return dict(self.cfg["reference"], total_steps=self.total_steps)

    @staticmethod
    def program_readings(st: dict) -> dict:
        """The logs, the first gradient as AdamW got it (from its first
        moment before and after the step) and the parameters after three
        steps."""
        m0 = st["start"]["m"] if st["start"] else None
        grad = {k: (v - 0.9 * m0[k] if m0 else v) / 0.1
                for k, v in st["moment1"].items()}
        return {"logs": st["logs"], "grad": grad, "params": st["params3"]}

    def _numbers(self, precision: str | None) -> dict:
        """The comparison's numbers, each the larger of the two followed
        epochs': the program's (`precision` None) or the reference's in
        `precision` (the control) against the float32 reference."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        hp, out = self._hp(), {}
        for name, st in self._stages():
            batches = self._batches(st)
            ref = ref_bince.follow(st["params0"], batches, hp, "fp32",
                                   start=st["start"])
            got = self.program_readings(st) if precision is None else \
                ref_bince.follow(st["params0"], batches, hp, precision,
                                 start=st["start"])
            numbers = compare(got, ref, st["params0"])
            self.info[f"{name}_numbers"] = numbers
            for k, v in numbers.items():
                out[k] = max(out.get(k, 0.0), v)
        return out

    def check(self) -> dict:
        checks = {k: {"value": v, "limit": self.limits[k]}
                  for k, v in self._numbers(None).items()}
        self.failed = 0 if all(c["value"] <= c["limit"]
                               for c in checks.values()) else 3 * self.batch
        return checks

    def control(self) -> dict:
        return self._numbers("fp8")


def _copy(draw):
    if draw is None:
        return None
    return [{k: v.clone() for k, v in d.items()} for d in draw]


RATE_LEAVES = ("rate_estimator.entropy_bottleneck.matrix",
               "rate_estimator.entropy_bottleneck.bias",
               "rate_estimator.entropy_bottleneck.factor",
               "rate_estimator.affine.biasing")


def _worst_leaf_gap(got: dict, ref: dict, keys) -> float:
    norms = {k: float(ref[k].float().norm()) for k in keys}
    med = float(np.median(list(norms.values())))
    return max(abs(float(got[k].float().norm()) - norms[k])
               / max(norms[k], med) for k in keys)


def compare(got: dict, ref: dict, init: dict) -> dict:
    """The numbers the training check compares: the largest relative gap
    of the logged loss, rate and distortion over the three steps; by the
    worst leaf the gap of the first gradient's norm and of the norm of the
    parameters' change after three steps (leaves whose reference gradient
    is under a thousandth of the median leaf's left out of the change);
    and by the worst of the leaves that only the rate reaches (the prior's
    chain and the affine's bias, whose gradient is K3's backward, scaled
    by the annealed beta) the gap of their first gradient's norm, against
    the median of those leaves, so the beta cancels."""
    out = {}
    for k in ("loss", "rate", "distortion"):
        out[f"{k}_gap"] = max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-12)
                              for g, r in zip(got["logs"], ref["logs"]))
    keys = list(ref["grad"])
    out["grad_norm_gap"] = _worst_leaf_gap(got["grad"], ref["grad"], keys)
    rate = [k for k in keys if k.startswith(RATE_LEAVES)]
    out["rate_grad_gap"] = _worst_leaf_gap(got["grad"], ref["grad"], rate)
    gnorm = {k: float(ref["grad"][k].norm()) for k in keys}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in keys if gnorm[k] >= 1e-3 * med]
    change = {k: got["params"][k].float() - init[k].float() for k in moved}
    ref_change = {k: ref["params"][k] - init[k].float() for k in moved}
    out["change_norm_gap"] = _worst_leaf_gap(change, ref_change, moved)
    return out
