"""gc_ms.plan: the collector's pauses inside a plan (``last_timers["gc"]``,
from ``gc.callbacks``, installed only under tracing, so read from the
traced run), mean over the window's plans, those without a collection
counting 0. A program without the record leaves the metric out."""
SOURCE = "program_span"
MOVES = "plan_ms"


def read(run):
    vals = [r["timers"]["gc"] for r in run.records
            if r["ok"] and "gc" in r.get("timers", {})]
    if run.kind != "plan" or not vals:
        return None
    return sum(vals) / len(vals)
