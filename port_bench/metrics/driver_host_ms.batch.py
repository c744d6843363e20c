"""Window time outside the synchronized assembly, damped-solve and cost spans, per global step (ms): the serving driver's own host work."""


def read(rec):
    if rec.get("kind") != "batch":
        return None
    return 1e3 * (rec["window_s"] - sum(rec["span_s"].values())) / rec["global_steps"]
