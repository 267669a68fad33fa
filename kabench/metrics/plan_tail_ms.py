"""plan_tail_ms: the 95th percentile of every plan's latency in the traced
window (host clock around the plan call, linear interpolation between
ranks). Some 5% of plans take a full collection of the Python heap (at
config 4 150-250 ms more in decode), so the 95th percentile sits on that
edge and swings from run to run by more than an end-to-end bound may
allow: it stands here, unbounded, beside ``plan_ms``."""
import numpy as np

SOURCE = "host_clock"
MOVES = "plan_ms"


def read(run):
    lat = [(r["t1"] - r["t0"]) * 1e3 for r in run.records if r["ok"]]
    if run.kind != "plan" or not lat:
        return None
    return float(np.percentile(lat, 95))
