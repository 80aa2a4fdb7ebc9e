"""Whole step: a sample's operations of a BINCE step (`counts.py`: both
views through ResNet-18 and the projector, forward and backward, and the
probe) times the window's img/s, as a share of the card's dense bf16
peak."""

from benchmark import counts


def read(rec):
    rate = rec.window.get("train_img_per_s")
    if not rate:
        return None
    m, h, w = rec.cell.config["model"], 96, 96
    flops = counts.bince_train_flops(h, w, m["z_dim"], m["project_dim"],
                                     m["online_probe_hidden"], 10)
    return 100.0 * flops * rate / counts.PEAK_FLOPS["bfloat16"]
