"""Synchronized assembly span time per global step, over the batch's pairs (ms)."""


def read(rec):
    if rec.get("kind") != "batch":
        return None
    return 1e3 * rec["span_s"]["assembly"] * rec["batch"] / rec["span_calls"]["assembly"]
