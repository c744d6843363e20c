"""LM trials (damped solves) per inner solve over the window, from the program's ``outer.SolveStats``."""


def read(rec):
    if rec.get("kind") != "sweep":
        return None
    return rec["lm_solves"] / rec["inner_solves"]
