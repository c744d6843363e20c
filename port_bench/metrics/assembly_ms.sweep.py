"""Synchronized assembly span time (dense, block and rigid Gauss-Newton systems) per inner solve (ms)."""


def read(rec):
    if rec.get("kind") != "sweep":
        return None
    return 1e3 * rec["span_s"].get("assembly", 0.0) / rec["inner_solves"]
