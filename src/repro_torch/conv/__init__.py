"""Convolution dispatch, offline weight packing and scale calibration,
K4 tile autotuning and the per-layer planner (see
``repro_torch.conv.engine`` for the backends and the lifecycle)."""
from repro_torch.conv.engine import ConvEngine
from repro_torch.conv.packing import (PackedWinogradWeights, merge_abs_max,
                                      observed_abs_max, pack_weights,
                                      scales_from_abs_max)
from repro_torch.conv.planner import (CandidateCost, LayerGeom, Plan,
                                      PlanEntry, build_plan,
                                      candidate_entries, measure_layer,
                                      plan_cost_us, solve_plan)
from repro_torch.conv.policy import BACKENDS, ConvPolicy

__all__ = [
    "BACKENDS",
    "ConvEngine",
    "ConvPolicy",
    "PackedWinogradWeights",
    "pack_weights",
    "observed_abs_max",
    "merge_abs_max",
    "scales_from_abs_max",
    "PlanEntry",
    "Plan",
    "LayerGeom",
    "CandidateCost",
    "candidate_entries",
    "measure_layer",
    "solve_plan",
    "plan_cost_us",
    "build_plan",
]
