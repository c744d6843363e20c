"""Share of the profiled stretch in which no operation ran on the device (%)."""


def read(rec):
    if rec.get("kind") != "batch":
        return None
    return 100.0 * (1.0 - rec["summary"]["busy_s"] / rec["summary"]["length_s"])
