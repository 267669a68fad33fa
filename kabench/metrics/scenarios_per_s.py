"""scenarios_per_s: removal scenarios answered over the window's time."""
SOURCE = "host_clock"


def read(run):
    if run.kind != "whatif":
        return None
    return sum(r.get("units", 0) for r in run.records if r["ok"]) / run.window_s
