"""whatif_mesh_skew_ms: how long a scenario-sharded what-if request's
fastest position waits for its slowest, each mesh call's slowest wall
minus its fastest (``whatif.last_sweep["mesh_skew"]``, summed over the
request's mesh calls), mean per request. A program without the record
leaves the metric out."""
SOURCE = "program_span"
MOVES = "scenarios_per_s"
KEY = "mesh_skew"


def read(run):
    vals = [r["sweep"][KEY] for r in run.records
            if r["ok"] and KEY in r.get("sweep", {})]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
