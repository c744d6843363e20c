"""Kernel 2 (block PCG) in the profiled stretches: the least time of its launches (``roofline.block_pcg_s``: inputs read once, x written once) over their device time (%). Nothing to read where the stretches hold no
launch of the kernel."""


def read(rec):
    if rec.get("kind") != "sweep":
        return None
    f = rec["summary"]["families"].get("kernel2")
    if not f or f["events"] == 0 or f["device_s"] <= 0.0:
        return None
    return 100.0 * f["least_s"] / f["device_s"]
