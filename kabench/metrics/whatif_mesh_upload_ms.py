"""whatif_mesh_upload_ms: a scenario-sharded what-if request's copies of
the cluster's arrays to each position's card, until they are done
(``whatif.last_sweep["mesh_upload"]``, the ``ka/whatif/mesh_upload`` span,
summed over the request's mesh calls), mean per request. A program
without the record leaves the metric out."""
SOURCE = "program_span"
MOVES = "scenarios_per_s"
KEY = "mesh_upload"


def read(run):
    vals = [r["sweep"][KEY] for r in run.records
            if r["ok"] and KEY in r.get("sweep", {})]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
