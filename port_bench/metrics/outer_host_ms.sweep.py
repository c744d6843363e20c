"""Window time outside the synchronized assembly, damped-solve and cost spans, per inner solve (ms): the pipeline, the outer search and the LM loop's own host work."""


def read(rec):
    if rec.get("kind") != "sweep":
        return None
    return 1e3 * (rec["window_s"] - sum(rec["span_s"].values())) / rec["inner_solves"]
