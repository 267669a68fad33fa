"""whatif_per_call: the scenarios a what-if request's largest placement
call held (``whatif.last_sweep["per_call"]``, sized from the card's memory
by ``ops/assignment.py:sweep_scenarios_per_call``), mean per request. A
program without the record leaves the metric out."""
SOURCE = "program_counter"
MOVES = "scenarios_per_s"


def read(run):
    vals = [r["sweep"]["per_call"] for r in run.records
            if r["ok"] and "per_call" in r.get("sweep", {})]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
