"""whatif_mesh_slowest_ms: a scenario-sharded what-if request's slowest
position, each mesh call's (its wall in its own thread, from its sweep's
start to its outputs on the host; ``whatif.last_sweep["mesh_slowest"]``,
summed over the request's mesh calls), mean per request. A program
without the record leaves the metric out."""
SOURCE = "program_span"
MOVES = "scenarios_per_s"
KEY = "mesh_slowest"


def read(run):
    vals = [r["sweep"][KEY] for r in run.records
            if r["ok"] and KEY in r.get("sweep", {})]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
