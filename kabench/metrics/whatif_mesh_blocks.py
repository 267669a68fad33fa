"""whatif_mesh_blocks: the mesh calls of a scenario-sharded what-if
request, each a block of ``KA_WHATIF_MEMBUDGET``'s scenarios split over
the positions (``whatif.last_sweep["mesh_blocks"]``), mean per request.
A program without the record leaves the metric out."""
SOURCE = "program_counter"
MOVES = "scenarios_per_s"
KEY = "mesh_blocks"


def read(run):
    vals = [r["sweep"][KEY] for r in run.records
            if r["ok"] and KEY in r.get("sweep", {})]
    if run.kind != "whatif" or not vals:
        return None
    return sum(vals) / len(vals)
