"""whatif_wait_ms: the host's wall ms blocked in a what-if request's
device-to-host reads (``whatif.last_sweep["wait"]``, the reads that
``whatif_syncs`` counts), mean per request: the part of
``whatif_sweep_ms`` the host waits on the card. A program without the
record leaves the metric out."""
SOURCE = "program_span"
MOVES = "scenarios_per_s"


def read(run):
    vals = [r["sweep"]["wait"] for r in run.records
            if r["ok"] and "wait" in r.get("sweep", {})]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
