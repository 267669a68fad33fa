"""leadership_ms.plan: the plan's ``leadership`` phase (``TorchSolver.last_timers``,
which ends in a device synchronize), mean over the window's plans."""
SOURCE = "program_span"
MOVES = "plan_ms"


def read(run):
    vals = [r["timers"]["leadership"] for r in run.records
            if r["ok"] and "leadership" in r.get("timers", {})]
    if run.kind != "plan" or not vals:
        return None
    return sum(vals) / len(vals)
