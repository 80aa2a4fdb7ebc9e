"""`data.images` / `data.augmentations`: device milliseconds of the
kernels launched inside the harness's `bench.sampler` range around the
sampler it hands the epoch, a traced step."""


def read(rec):
    s = rec.slice
    if s is None:
        return None
    k = s.launched_under(r"^bench\.sampler$")
    return 1e3 * s.device_s(k) / rec.info["slice_steps"] if k else None
