"""torchvision-layout ResNet weights -> the port's `nn.resnet.ResNet`.

Counterpart of `lossyless_tpu/nn/convert_resnet.py`: plain supervised
ResNet-50 state dicts and the SimCLR / SwAV backbones (pl_bolts exports
the same layout). CLIP's RN50 is not in this layout (3-conv stem,
average-pool downsampling, attention-pool head): it converts through
`nn.clip_resnet.convert_clip_resnet`.

`convert_torchvision_resnet` returns JAX's (params, batch_stats) flax
trees (`Conv_i`, `BatchNorm_i`, `BasicBlock_k` / `BottleneckBlock_k`,
`Dense_0` only with `include_head`), which `layers.params_from_flax`
carries onto the port's ResNet as they are; `load_into` merges them into
a state dict, where the entries the converter skipped (the head) keep
their values.
"""

from __future__ import annotations

from .layers import merge_stats, numpy_state_dict, params_from_flax

STAGE_SIZES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
               "resnet50": (3, 4, 6, 3)}
BOTTLENECK = {"resnet18": False, "resnet34": False, "resnet50": True}


def convert_torchvision_resnet(state_dict, base: str = "resnet50",
                               include_head: bool = False):
    sd = numpy_state_dict(state_dict)

    def conv(name):
        return {"kernel": sd[f"{name}.weight"].transpose(2, 3, 1, 0)}

    def bn(name):
        p = {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}
        s = {"mean": sd[f"{name}.running_mean"],
             "var": sd[f"{name}.running_var"]}
        return p, s

    params, stats = {}, {}
    params["Conv_0"] = conv("conv1")
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn("bn1")

    bottleneck = BOTTLENECK[base]
    n_convs = 3 if bottleneck else 2
    block_cls = "BottleneckBlock" if bottleneck else "BasicBlock"
    block_idx = 0
    for stage, n_blocks in enumerate(STAGE_SIZES[base], start=1):
        for j in range(n_blocks):
            tv = f"layer{stage}.{j}"
            bp, bs = {}, {}
            for c in range(n_convs):
                bp[f"Conv_{c}"] = conv(f"{tv}.conv{c + 1}")
                bp[f"BatchNorm_{c}"], bs[f"BatchNorm_{c}"] = bn(
                    f"{tv}.bn{c + 1}")
            if f"{tv}.downsample.0.weight" in sd:
                bp[f"Conv_{n_convs}"] = conv(f"{tv}.downsample.0")
                bp[f"BatchNorm_{n_convs}"], bs[f"BatchNorm_{n_convs}"] = bn(
                    f"{tv}.downsample.1")
            key = f"{block_cls}_{block_idx}"
            params[key], stats[key] = bp, bs
            block_idx += 1

    if include_head and "fc.weight" in sd:
        params["Dense_0"] = {"kernel": sd["fc.weight"].T,
                             "bias": sd["fc.bias"]}
    return params, stats


def load_into(state_dict: dict, converted_params: dict,
              converted_stats: dict) -> dict:
    """`state_dict` (a ResNet's) with the converted weights in place; the
    entries the converter skipped keep their values. Every converted
    entry must name a tensor of `state_dict` of its shape."""
    loaded = params_from_flax(merge_stats(converted_params,
                                          converted_stats))
    bad = [k for k, v in loaded.items()
           if k not in state_dict or state_dict[k].shape != v.shape]
    if bad:
        raise ValueError(f"converted weights do not fit the ResNet: "
                         f"{bad[:12]}")
    return {**state_dict, **loaded}
