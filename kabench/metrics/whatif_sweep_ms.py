"""whatif_sweep_ms: a what-if request's device phases (``whatif.last_sweep``
``sweep`` and ``rescue``, each ending in a synchronize), mean per request."""
SOURCE = "program_span"
MOVES = "scenarios_per_s"


def read(run):
    vals = [r["sweep"].get("sweep", 0.0) + r["sweep"].get("rescue", 0.0)
            for r in run.records if r["ok"] and "sweep" in r]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
