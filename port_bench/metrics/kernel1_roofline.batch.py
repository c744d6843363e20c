"""Kernel 1's batched entry in the profiled stretch: the least time of its launches (B times ``roofline.damped_solve_s``) over their device time (%). Nothing to read where the stretches hold no
launch of the kernel."""


def read(rec):
    if rec.get("kind") != "batch":
        return None
    f = rec["summary"]["families"].get("kernel1")
    if not f or f["events"] == 0 or f["device_s"] <= 0.0:
        return None
    return 100.0 * f["least_s"] / f["device_s"]
