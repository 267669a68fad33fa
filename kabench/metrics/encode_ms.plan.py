"""encode_ms.plan: the plan's ``encode`` phase (``TorchSolver.last_timers``,
which ends in a device synchronize), mean over the window's plans."""
SOURCE = "program_span"
MOVES = "plan_ms"


def read(run):
    vals = [r["timers"]["encode"] for r in run.records
            if r["ok"] and "encode" in r.get("timers", {})]
    if run.kind != "plan" or not vals:
        return None
    return sum(vals) / len(vals)
