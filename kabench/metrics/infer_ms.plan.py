"""infer_ms.plan: the plan entry's RF inference (``last_timers["infer"]``,
the span ``infer`` of ``TopicAssigner.generate_assignments``: a Python pass
over every partition), mean over the window's plans. A program without the
span records nothing, and the metric is left out."""
SOURCE = "program_span"
MOVES = "plan_ms"


def read(run):
    vals = [r["timers"]["infer"] for r in run.records
            if r["ok"] and "infer" in r.get("timers", {})]
    if run.kind != "plan" or not vals:
        return None
    return sum(vals) / len(vals)
