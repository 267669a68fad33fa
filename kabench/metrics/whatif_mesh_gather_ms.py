"""whatif_mesh_gather_ms: a scenario-sharded what-if request's gather of
its positions' outputs and records in scenario order
(``whatif.last_sweep["mesh_gather"]``, the ``ka/whatif/mesh_gather`` span,
summed over the request's mesh calls), mean per request. A program
without the record leaves the metric out."""
SOURCE = "program_span"
MOVES = "scenarios_per_s"
KEY = "mesh_gather"


def read(run):
    vals = [r["sweep"][KEY] for r in run.records
            if r["ok"] and KEY in r.get("sweep", {})]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
