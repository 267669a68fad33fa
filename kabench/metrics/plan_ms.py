"""plan_ms: an operator's wait for a reassignment plan, as all the window's
time over all the plans completed in it (one client, plans back to back)."""
SOURCE = "host_clock"


def read(run):
    done = [r for r in run.records if r["ok"]]
    if run.kind != "plan" or not done:
        return None
    return run.window_s * 1e3 / len(done)
