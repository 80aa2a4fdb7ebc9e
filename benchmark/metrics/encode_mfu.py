"""Whole encode: the tower's forward operations an image (`counts.py`)
times the window's img/s, as a share of the card's dense bf16 peak."""

from benchmark import counts


def read(rec):
    rate = rec.window.get("encode_img_per_s")
    if not rate:
        return None
    t = rec.cell.config["tower"]
    flops = counts.vit_forward_flops(t["width"], t["layers"], t["patch"],
                                     t["image"], t["out_dim"])
    return 100.0 * flops * rate / counts.PEAK_FLOPS["bfloat16"]
