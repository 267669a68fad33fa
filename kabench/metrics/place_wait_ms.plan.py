"""place_wait_ms.plan: the part of the plan's ``place`` phase the host spent
blocked in reads of the device (``last_timers["place_wait"]``: a wave
loop's flag each wave, the quota leg's branch flags, the stranded rows
after each leg, the infeasible flags), mean over the window's plans. It
reads no more than ``place_ms.plan``. A program without the record leaves
the metric out."""
SOURCE = "program_span"
MOVES = "plan_ms"


def read(run):
    vals = [r["timers"]["place_wait"] for r in run.records
            if r["ok"] and "place_wait" in r.get("timers", {})]
    if run.kind != "plan" or not vals:
        return None
    return sum(vals) / len(vals)
