"""`nn.flash_attn` K1 + K2 in the traced pass: the attention's bound at
every batch's shapes (`counts.vit_attention_bound_s`) over the device time
of the attention kernels, as a share. Where the port's launch counters
show attention kernels launched in the slice and the trace names none of
them, the names below are stale: that is an error, not a missing
metric."""

from benchmark import counts

KERNELS = (r"\b(attention_tile_kernel|k5_onepass_kernel|attention_kernel"
           r"|k2_attention_kernel|packed_attention_\w+_kernel"
           r"|headbatched_attention_\w+_kernel)\b")


def read(rec):
    s, batches = rec.slice, rec.info.get("slice_batches")
    if s is None or not s.device or not batches:
        return None
    kernels = s.matching(KERNELS)
    launched = sum(v for k, v in rec.info.get("slice_launches", {}).items()
                   if k.startswith("fused_attention"))
    if not kernels:
        if launched:
            raise RuntimeError(f"{launched} attention launches in the slice "
                               f"and no trace kernel matches {KERNELS}")
        return None
    t = rec.cell.config["tower"]
    tokens = counts.vit_tokens(t["image"], t["patch"])
    bound = sum(counts.vit_attention_bound_s(
        b, t["layers"], tokens, t["heads"], t["width"] // t["heads"])
        for b in batches)
    return 100.0 * bound / s.device_s(kernels)
