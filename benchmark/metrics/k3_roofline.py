"""`coding.eb_kernel` K3 and its backward in the traced steps: each
launch's bound at the step's (rows, channels) and filters (`counts.py`)
over the device time of the two kernels, as a share. Where the port's
launch counters show K3 launched in the slice and the trace names none
of its kernels, the names below are stale: that is an error, not a
missing metric."""

from benchmark import counts

FORWARD = r"\beb_likelihood_kernel\b"
BACKWARD = r"\beb_likelihood_bwd_kernel\b"


def read(rec):
    s = rec.slice
    if s is None or not s.device:
        return None
    fwd, bwd = s.matching(FORWARD), s.matching(BACKWARD)
    if not fwd and not bwd:
        launched = sum(rec.info.get("slice_launches", {}).values())
        if launched:
            raise RuntimeError(f"{launched} K3 launches in the slice and no "
                               f"trace kernel matches {FORWARD} or "
                               f"{BACKWARD}")
        return None
    m, b = rec.cell.config["model"], rec.info["batch"]
    f = tuple(m["eb_filters"])
    bound = len(fwd) * counts.k3_forward_bound_s(b, m["z_dim"], f) \
        + len(bwd) * counts.k3_backward_bound_s(b, m["z_dim"], f)
    return 100.0 * bound / s.device_s(fwd + bwd)
