"""The program's ``assembly.mesh_jacobian`` spans (the forward-mode slot Jacobian of a mesh energy other than ARAP's block path) per inner solve (ms): the spans that ended at or before the window's close, as ``drivers/sweep_energy.py`` collects them. Nothing to read without the program's recording or where the program has no such span."""


def read(rec):
    s = rec.get("program_window", {}).get("assembly.mesh_jacobian")
    if rec.get("kind") != "sweep" or s is None:
        return None
    return 1e3 * s["total_s"] / rec["inner_solves"]
