"""Courier core — the paper's contribution as a composable PyTorch library.

Flow (paper Fig. 1):
  Frontend.trace        Steps 1-5  — runtime trace of an unmodified callable
  (user edit_ir hook)   Steps 6-7  — inspect/modify the Courier IR
  PipelineGenerator     Step 8     — DB lookup, fusion, balanced partition,
                                     mixed sw/hw token pipeline
  courier_offload       Step 9     — deployable wrapper w/ Off-load Switcher
  pipeline_microbatches             — the token pipeline across ranks
                                     (microbatches through layer stages)
"""
from .costmodel import (DEVICE_CLASSES, H100, PROFILE_MARGIN, SMEM_BYTES,
                        CostModel, DeviceClass, FusionEstimate, NodeCost,
                        attention_cost, device_class, elementwise_cost,
                        fused_cost, matmul_cost, measure_ms,
                        measured_contradicts, replicated_bottleneck_ms,
                        stencil_cost, synchronize, transfer_ms)
from .database import ModuleDatabase, ModuleEntry, default_db
from .executor import (ExecutorClosed, ExecutorStats, PendingToken,
                       PipelineExecutor, StageCounters, SubmitError)
from .ir import CourierIR, Node, Value, linear_ir
from .offloader import OffloadedFunction, OffloadPlan, courier_offload
from .partition import (PipelinePlan, StagePlan, assign_replicas,
                        assign_stage_devices, clear_stage_devices,
                        fuse_adjacent_hw, fused_working_set_bytes,
                        kernel_tile, make_model_fused_cost, partition_optimal,
                        partition_paper, split_fused_node, stencil_tile_bytes,
                        widen_for_deployment, working_set_bytes)
from .pipeline import (BuiltPipeline, PipelineGenerator, StageFn,
                       assign_placements, loop_batched, make_stage_fns)
from .profiler import StageProfiler
from .spmd_pipeline import (pipeline_microbatches, spmd_pipeline_fn,
                            stack_stage_params, stage_apply)
from .placement import (AUTO_BUDGET, DeviceInventory, DeviceSpec,
                        InventoryDiff, Placement, default_worker_budget, is_hw,
                        is_sw, placement_kind, resolve_device,
                        resolve_worker_budget)
from .tracer import Frontend, Library, current_mode, deploy

__all__ = [
    "DEVICE_CLASSES", "H100", "PROFILE_MARGIN", "SMEM_BYTES", "CostModel",
    "DeviceClass", "FusionEstimate", "NodeCost", "attention_cost",
    "device_class", "elementwise_cost", "fused_cost", "matmul_cost",
    "measure_ms", "measured_contradicts", "replicated_bottleneck_ms",
    "stencil_cost", "synchronize", "transfer_ms",
    "ModuleDatabase", "ModuleEntry", "default_db",
    "ExecutorClosed", "ExecutorStats", "PendingToken", "PipelineExecutor",
    "StageCounters", "SubmitError",
    "CourierIR", "Node", "Value", "linear_ir",
    "OffloadedFunction", "OffloadPlan", "courier_offload",
    "PipelinePlan", "StagePlan", "assign_replicas", "assign_stage_devices",
    "clear_stage_devices", "fuse_adjacent_hw", "fused_working_set_bytes",
    "make_model_fused_cost", "partition_optimal", "partition_paper",
    "split_fused_node", "working_set_bytes", "stencil_tile_bytes",
    "kernel_tile", "widen_for_deployment",
    "BuiltPipeline", "PipelineGenerator", "StageFn", "assign_placements",
    "loop_batched", "make_stage_fns", "StageProfiler",
    "pipeline_microbatches", "spmd_pipeline_fn", "stack_stage_params",
    "stage_apply",
    "AUTO_BUDGET", "DeviceInventory", "DeviceSpec", "InventoryDiff",
    "Placement",
    "default_worker_budget", "is_hw", "is_sw", "placement_kind",
    "resolve_device", "resolve_worker_budget",
    "Frontend", "Library", "current_mode", "deploy",
]
