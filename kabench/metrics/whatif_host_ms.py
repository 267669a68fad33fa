"""whatif_host_ms: a what-if request's host phases (``whatif.last_sweep``
``prep``: encode, masks, topic facts, upload; and ``compose``), mean per
request."""
SOURCE = "program_span"
MOVES = "scenarios_per_s"


def read(run):
    vals = [r["sweep"].get("prep", 0.0) + r["sweep"].get("compose", 0.0)
            for r in run.records if r["ok"] and "sweep" in r]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
