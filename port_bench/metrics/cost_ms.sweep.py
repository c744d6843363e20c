"""Synchronized cost span time (deformable and rigid robust cost) per inner solve (ms)."""


def read(rec):
    if rec.get("kind") != "sweep":
        return None
    return 1e3 * rec["span_s"].get("cost", 0.0) / rec["inner_solves"]
