"""whatif_syncs: a what-if request's device-to-host reads, the sweep's and
its rescue's (``whatif.last_sweep["syncs"]``: a wave loop's flag each wave,
each chunk's stranded rows and ``bincount``, three output reads a call),
mean per request. A program without the counter leaves the metric out."""
SOURCE = "program_counter"
MOVES = "scenarios_per_s"


def read(run):
    vals = [r["sweep"]["syncs"] for r in run.records
            if r["ok"] and "syncs" in r.get("sweep", {})]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
