"""Plain BINCE training steps (Dubois et al. 2021, the `stl10_bince`
recipe of YannDubs/lossyless `bin/stl10`), in float32 with TF32 off.

One step on a batch of raw images, its labels and the step's draws:

* the two views: STL10's chain (horizontal flip, random resized crop by
  bilinear sampling with edge clamping, colour jitter: brightness,
  contrast about the image mean, saturation about the pixel's grey, the
  hue shift toward the next channel, clipped to [0, 1]; random greyscale
  by 0.299 / 0.587 / 0.114), each view on its own draws;
* the encoder: ResNet-18 with the small-image stem (3 x 3 stride 1, no
  max-pool), BatchNorm in training mode (biased batch variance, eps
  1e-5), global mean pool and a dense head to z;
* the rate: the factorized prior on (z + b) * exp(s) plus U(-0.5, 0.5)
  noise, -log of the likelihood (the sigmoid difference on the side of
  the smaller magnitude, floored at 1e-9 with CompressAI's gradient)
  summed over z; the noisy z mapped back for the distortion;
* the distortion: InfoNCE over both views' projected, L2-normalised
  representations at the learned temperature 1 / min(exp(logit_scale),
  1 / 0.01), each view's loss averaged a sample;
* the loss: distortion + beta * rate, beta annealed linearly from
  1e-5 beta over 1000 steps (its value logged at the final beta), plus
  the online probe's cross entropy on the detached z and the entropy
  model's quantile loss;
* AdamW (decoupled weight decay) in three groups (the probe, the
  quantiles, the rest), their rates decayed exponentially by
  `decay_factor` over the planned steps.

`precision="fp8"` rounds both inputs of every convolution and product to
float8 e4m3 (one scale a tensor): the control of the comparison. The
parameters are a dict of float32 tensors under the names the benchmark
makes them with (convolution kernels (out, in, kh, kw), dense kernels
(in, out)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .vit import fp8

LOG2 = math.log(2.0)
LIKELIHOOD_FLOOR = 1e-9
TAIL_MASS = 1e-9


# -- the views --------------------------------------------------------------

def _each(v):
    return v.reshape(-1, 1, 1, 1)


def _crop(x, d):
    """Random resized crop: output pixel i samples (i + 0.5) * frac + start
    - 0.5 of the source, bilinear, coordinates clamped to the image."""
    b, h, w, _ = x.shape
    r = torch.exp(d["log_r"])
    ch = torch.sqrt(d["area"] / r).clamp(max=1.0)
    cw = torch.sqrt(d["area"] * r).clamp(max=1.0)
    y0 = d["u_y"] * (1 - ch) * h
    x0 = d["u_x"] * (1 - cw) * w

    def taps(n, frac, start):
        pos = (torch.arange(n, device=x.device)[None] + 0.5) * frac[:, None] \
            + start[:, None] - 0.5
        pos = pos.clamp(0, n - 1)
        lo = pos.floor().long()
        return lo, (lo + 1).clamp(max=n - 1), pos - lo

    ylo, yhi, wy = taps(h, ch, y0)
    xlo, xhi, wx = taps(w, cw, x0)
    bi = torch.arange(b, device=x.device)[:, None, None]

    def at(yi, xi):
        return x[bi, yi[:, :, None], xi[:, None, :]]

    wy, wx = wy[:, :, None, None], wx[:, None, :, None]
    return (at(ylo, xlo) * (1 - wy) * (1 - wx) + at(ylo, xhi) * (1 - wy) * wx
            + at(yhi, xlo) * wy * (1 - wx) + at(yhi, xhi) * wy * wx)


def _color(x, d):
    out = x * _each(d["brightness"])
    m = out.mean(dim=(1, 2, 3), keepdim=True)
    out = (out - m) * _each(d["contrast"]) + m
    g = out.mean(dim=-1, keepdim=True)
    out = (out - g) * _each(d["saturation"]) + g
    out = out + _each(d["hue"]) * (out[..., [2, 0, 1]] - out)
    return torch.where(_each(d["apply"]), out.clamp(0, 1), x)


def _gray(x, d):
    lum = 0.299 * x[..., :1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:]
    return torch.where(_each(d["apply"]), lum.expand_as(x), x)


def view(raw, draws):
    """STL10's chain on [0, 1] NHWC images: draws = [flip, crop, colour,
    grey], each a dict of per-image values."""
    flip, crop, color, gray = draws
    x = torch.where(_each(flip["flip"]), raw.flip(2), raw)
    return _gray(_color(_crop(x, crop), color), gray)


# -- the model --------------------------------------------------------------

class Step:
    """The loss of one step as a function of the parameters."""

    def __init__(self, hp: dict, precision: str = "fp32"):
        self.hp = hp
        self.q = fp8 if precision == "fp8" else (lambda t: t)

    def _conv(self, x, k, stride):
        return F.conv2d(self.q(x), self.q(k), None, stride, k.shape[-1] // 2)

    @staticmethod
    def _bn(x, p, name):
        mean = x.mean((0, 2, 3), keepdim=True)
        var = x.var((0, 2, 3), unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) \
            * p[name + ".scale"].view(1, -1, 1, 1) \
            + p[name + ".bias"].view(1, -1, 1, 1)

    def _dense(self, x, p, name):
        return self.q(x) @ self.q(p[name + ".kernel"]) + p[name + ".bias"]

    def encoder(self, p, x):
        e = "p_ZlX.mapper."
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self._bn(self._conv(x, p[e + "Conv_0.kernel"], 1), p,
                            e + "BatchNorm_0"))
        cin = 64
        for i in range(8):
            b = f"{e}BasicBlock_{i}."
            stride = 2 if i in (2, 4, 6) else 1
            cout = p[b + "Conv_0.kernel"].shape[0]
            y = F.relu(self._bn(self._conv(x, p[b + "Conv_0.kernel"], stride),
                                p, b + "BatchNorm_0"))
            y = self._bn(self._conv(y, p[b + "Conv_1.kernel"], 1), p,
                         b + "BatchNorm_1")
            r = x
            if stride != 1 or cin != cout:
                r = self._bn(self._conv(x, p[b + "Conv_2.kernel"], stride), p,
                             b + "BatchNorm_2")
            x, cin = F.relu(y + r), cout
        return self._dense(x.mean((2, 3)), p, e + "Dense_0")

    @staticmethod
    def _logits_cdf(p, x):
        e = "rate_estimator.entropy_bottleneck."
        n = sum(1 for k in p if k.startswith(e + "matrix"))
        u = x
        for i in range(n):
            u = torch.matmul(F.softplus(p[f"{e}matrix{i}"]), u) \
                + p[f"{e}bias{i}"]
            if i < n - 1:
                u = u + torch.tanh(p[f"{e}factor{i}"]) * torch.tanh(u)
        return u

    def rate(self, p, z, noise):
        """(z_hat mapped back, -log likelihood summed over z, a sample)."""
        a = "rate_estimator.affine."
        z_in = (z + p[a + "biasing"]) * torch.exp(p[a + "scaling"])
        z_hat = z_in + noise
        v = z_hat.t()[:, None, :]
        lower = self._logits_cdf(p, v - 0.5)
        upper = self._logits_cdf(p, v + 0.5)
        s = -torch.sign(lower + upper).detach()
        lik = (torch.sigmoid(s * upper) - torch.sigmoid(s * lower)).abs()
        lik = _LowerBound.apply(lik[:, 0, :].t(), LIKELIHOOD_FLOOR)
        return z_hat / torch.exp(p[a + "scaling"]) - p[a + "biasing"], \
            -torch.log(lik).sum(-1)

    def distortion(self, p, z, z_pos):
        d = "distortion_estimator."
        zs = torch.cat([z, z_pos])
        zs = self._dense(F.relu(self._dense(zs, p, d + "projector.Dense_0")),
                         p, d + "projector.Dense_1")
        zs = zs / torch.sqrt((zs * zs).sum(-1, keepdim=True) + 1e-12)
        n = zs.shape[0]
        temp = 1.0 / torch.minimum(p[d + "logit_scale"].exp(),
                                   torch.tensor(1.0 / self.hp["temperature"],
                                                device=zs.device))
        logits = self.q(zs) @ self.q(zs).t() / temp
        logits = logits.masked_fill(torch.eye(n, dtype=torch.bool,
                                              device=zs.device), -math.inf)
        pos = (torch.arange(n, device=zs.device) + n // 2) % n
        h = -F.log_softmax(logits, -1).gather(1, pos[:, None])[:, 0]
        return (h[:n // 2] + h[n // 2:]) / 2

    def probe(self, p, z, y):
        o = "online_evaluator.model.MLP_0."
        h = F.relu(self._dense(z.detach(), p, o + "Dense_0"))
        logits = self._dense(h, p, o + "Dense_1")
        return F.cross_entropy(logits, y)

    def quantile_loss(self, p):
        e = "rate_estimator.entropy_bottleneck."
        frozen = {k: (v.detach() if k.startswith(e) else v)
                  for k, v in p.items()}
        logits = self._logits_cdf(frozen, p[e + "quantiles"])
        t = math.log(2.0 / TAIL_MASS - 1.0)
        target = torch.tensor([-t, 0.0, t], device=logits.device)
        return (logits - target).abs().sum()

    def __call__(self, p, x, x_pos, y, noises, step: int):
        """(loss to differentiate, logs: loss, rate, distortion in bits)."""
        hp = self.hp
        z, rate = self.rate(p, self.encoder(p, x), noises[0])
        z_pos, _ = self.rate(p, self.encoder(p, x_pos), noises[1])
        dist = self.distortion(p, z, z_pos).mean()
        rate = rate.mean()
        beta = hp["beta"]
        loss = dist + annealed_beta(hp, step) * rate
        with torch.no_grad():
            logs = {"loss": float(dist + beta * rate) / LOG2,
                    "rate": float(rate) / LOG2,
                    "distortion": float(dist) / LOG2}
        return loss + self.probe(p, z, y) + self.quantile_loss(p), logs


class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    would raise x (CompressAI's `LowerBound`)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return x.clamp(min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x >= ctx.bound) | (g < 0)).to(g.dtype), None


# -- the optimizer ------------------------------------------------------------

def group(name: str) -> str:
    if name.endswith(".quantiles"):
        return "coder"
    if name.startswith("online_evaluator."):
        return "online"
    return "main"


def follow(params: dict, batches: list, hp: dict, precision: str = "fp32",
           n_steps: int = 3, start: dict | None = None) -> dict:
    """`n_steps` AdamW steps from `params` on `batches` (each (raw uint8
    images, labels, (x's draws, the positive's draws), (anchor noise,
    positive noise))). `start` continues a run: the global step of the
    first of them (`step`, which sets the annealed beta and the rates),
    and AdamW's moments (`m`, `v`) and update count a leaf (`count`);
    without it the run starts at step 0 with zero moments. Returns the
    logs of each step, the first step's gradients and the parameters after
    the last."""
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in params.items()}
    start = start or {}

    def moment(name, k):
        t = start.get(name, {}).get(k)
        return torch.zeros_like(p[k]) if t is None else t.float().clone()

    m = {k: moment("m", k) for k in p}
    v2 = {k: moment("v", k) for k in p}
    count = {k: start.get("count", {}).get(k, 0) for k in p}
    step0 = start.get("step", 0)
    b1, b2, eps = 0.9, 0.999, 1e-8
    step_fn = Step(hp, precision)
    logs, first_grad = [], None
    for t in range(n_steps):
        raw, y, (d_x, d_pos), noises = batches[t]
        x0 = raw.float() / 255.0
        loss, lg = step_fn(p, view(x0, d_x), view(x0, d_pos), y.long(),
                           noises, step0 + t)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        logs.append(lg)
        with torch.no_grad():
            grads = {k: (torch.zeros_like(p[k]) if g is None else g)
                     for k, g in zip(p, grads)}
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in grads.items()}
            for k, g in grads.items():
                o = hp["optim"][group(k)]
                lr = o["lr"] * (1.0 / o["decay_factor"]) ** (
                    (step0 + t) / hp["total_steps"])
                p[k].mul_(1 - lr * o["weight_decay"])
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                n = count[k] + t + 1
                c1, c2 = 1 - b1 ** n, 1 - b2 ** n
                p[k].sub_(lr / c1 * m[k] / (v2[k].sqrt() / math.sqrt(c2)
                                            + eps))
    return {"logs": logs, "grad": first_grad,
            "params": {k: v.detach() for k, v in p.items()}}


def annealed_beta(hp: dict, step: int) -> float:
    """The beta that weighs the rate's gradient at global step `step`."""
    beta = hp["beta"]
    start = beta * 1e-5
    return start + (beta - start) / hp["anneal_steps"] \
        * min(step, hp["anneal_steps"])
