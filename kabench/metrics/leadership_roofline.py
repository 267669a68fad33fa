"""leadership_roofline: the least time the card's memory allows for the bytes
the leadership ordering must move (``peaks.leadership_bytes``, from the
plan's shapes), over the leadership phase's mean time, in percent. The phase
is timed whatever implements it, so the same work is counted. The ordering
is a dependent chain, so this reads far below 1."""
from kabench import peaks

SOURCE = "program_span"
MOVES = "plan_ms"


def read(run):
    vals = [r["timers"]["leadership"] for r in run.records
            if r["ok"] and "leadership" in r.get("timers", {})]
    if run.kind != "plan" or not vals:
        return None
    s = run.shapes
    least = peaks.least_seconds(
        peaks.leadership_bytes(s["topics"], s["partitions"], s["rf"], s["brokers"]))
    return 100.0 * least / (sum(vals) / len(vals) / 1e3)
