from .mesh import build_mesh, scenario_sharding
from .whatif import evaluate_removal_scenarios

__all__ = ["build_mesh", "scenario_sharding", "evaluate_removal_scenarios"]
