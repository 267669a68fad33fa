"""Traffic driver ``sweep_mesh``: the ``sweep`` driver's what-if requests
over every card of the host, as ``RANK_DECOMMISSION`` lays them out: one
process, the mesh of ``parallel/mesh.py:auto_mesh`` (one scenario-axis
position a visible card, a thread each), passed to
``evaluate_removal_scenarios``. Parameters and check are ``sweep``'s.

A run needs as many positions as the cell's chips, and raises otherwise.
Against a program without ``auto_mesh`` the mesh is the one its
``RANK_DECOMMISSION`` builds over the visible cards.
"""
from __future__ import annotations

import sys

from kabench.drivers.sweep import Driver as SweepDriver


def program_mesh(device: str):
    """The program's own layout of a what-if sweep on ``device``."""
    from kafka_assigner_tpu_torch.parallel import mesh

    if hasattr(mesh, "auto_mesh"):
        return mesh.auto_mesh(device)
    local = mesh.visible_devices(device)
    return mesh.build_mesh(devices=local) if len(local) > 1 else None


class Driver(SweepDriver):
    def __init__(self, cell, seed: int, device: str) -> None:
        super().__init__(cell, seed, device)
        self.mesh = program_mesh(device)
        positions = self.mesh.shape["scenarios"] if self.mesh is not None else 1
        if positions != cell.chips:
            raise RuntimeError(f"{cell.name}: the program's mesh has {positions} "
                               f"scenario position(s), the cell asks for {cell.chips}")
        self.shapes["positions"] = positions

    def request(self, scenarios):
        return self.whatif.evaluate_removal_scenarios(
            self.topics, self.brokers, self.racks, scenarios, device=self.device,
            mesh=self.mesh)

    def release(self) -> None:
        """Each card's peak memory on standard error: every position has
        to have held its share of the sweep."""
        import torch

        if self.device == "cuda":
            peaks = [torch.cuda.max_memory_allocated(p.device)
                     for p in self.mesh.devices.flat]
            print(f"kabench: peak memory a position: {peaks}", file=sys.stderr)
