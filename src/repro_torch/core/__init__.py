# Port copy of repro/core/__init__.py, unchanged apart from this header.
"""EasyCrash core: the paper's contribution as a composable library.

Emulation/characterization layer (paper §3–5):
  blocks, arena, cache_sim, regions, crash_tester, selection, workflow
Production layer (paper §5.3 step 4 + §7):
  manager (flush runtime), efficiency (system model)
"""
from .adaptive import (
    AdaptiveReport,
    RegionEvidence,
    SequentialConfig,
    StaticPriorSampler,
    effective_sample_size,
    final_rate_interval,
    selection_invariant,
    shard_rounds,
    weighted_outcome_stats,
    wilson_interval,
)
from .arena import NVMArena, WriteStats
from .blocks import (
    DEFAULT_BLOCK_BYTES,
    block_diff_mask,
    inconsistent_rate,
    mix_blocks,
    num_blocks,
)
from .cache_sim import (
    ENGINES,
    CacheConfig,
    Flush,
    RegionEvents,
    Sweep,
    TornBlock,
    resolve_window_images,
    simulate_window,
    simulate_window_vec,
)
from .campaign_store import CampaignStore, CampaignStoreError, WorkflowStore
from .crash_tester import (
    CampaignResult,
    CrashRecord,
    CrashTester,
    PersistPlan,
    PlannedTest,
    default_engine,
)
from .trace_cache import WindowTraceCache, shared_trace_cache
from .faults import (
    FAULT_MODELS,
    BitFlip,
    CorrelatedRegion,
    FaultModel,
    MultiCrash,
    PowerFail,
    TornWrite,
    all_fault_models,
    fault_model_from_spec,
    get_fault_model,
)
from .artifacts import (
    STATIC_PLAN_KIND,
    ArtifactError,
    PlanArtifact,
    ProfileArtifact,
    StaticPlanArtifact,
    WorkflowArtifact,
    load_plan,
    load_profile,
    load_static_plan,
    load_workflow,
    profile_from_workflow,
    replay_plan,
    save_plan,
    save_profile,
    save_static_plan,
    save_workflow,
)
from .delta_persist import delta_block_mask, persist_mask_for
from .efficiency import (
    SystemConfig,
    efficiency_with,
    efficiency_without,
    expected_overhead,
    persist_overhead_fraction,
    scale_mtbf,
    tau_threshold,
    young_interval,
)
from .sysim import (
    POLICIES,
    FailureTrace,
    PoissonTrace,
    RecomputeProfile,
    SimResult,
    WeibullTrace,
    efficiency_frontier,
    optimize_interval,
    scaled_trace,
    simulate_policy,
    trace_from_spec,
)
from .fleetsim import (
    ArrivalProcess,
    FleetConfig,
    FleetResult,
    ServiceModel,
    fleet_frontier,
    simulate_fleet,
)
from .manager import EasyCrashManager, FlushPolicy, flatten_state, unflatten_state
from .regions import BatchedKernel, IterativeApp, Region, State, VerifyResult
from .selection import select_objects, select_regions, spearman
from .workflow import (
    CampaignSpec,
    RoundsResult,
    WorkflowConfig,
    WorkflowOrchestrator,
    WorkflowResult,
    run_workflow,
)

__all__ = [
    "NVMArena", "WriteStats", "DEFAULT_BLOCK_BYTES", "block_diff_mask",
    "inconsistent_rate", "mix_blocks", "num_blocks", "CacheConfig", "Flush",
    "RegionEvents", "Sweep", "TornBlock", "resolve_window_images",
    "simulate_window", "simulate_window_vec", "ENGINES",
    "CampaignStore", "CampaignStoreError", "WorkflowStore",
    "CampaignResult",
    "CrashRecord", "CrashTester", "PersistPlan", "PlannedTest",
    "default_engine", "WindowTraceCache", "shared_trace_cache",
    "FAULT_MODELS", "BitFlip", "CorrelatedRegion", "FaultModel", "MultiCrash",
    "PowerFail", "TornWrite", "all_fault_models", "fault_model_from_spec",
    "get_fault_model",
    "ArtifactError", "PlanArtifact", "ProfileArtifact", "StaticPlanArtifact",
    "WorkflowArtifact", "STATIC_PLAN_KIND",
    "load_plan", "load_profile", "load_static_plan", "load_workflow",
    "profile_from_workflow", "replay_plan", "save_plan", "save_profile",
    "save_static_plan", "save_workflow",
    "SystemConfig", "delta_block_mask", "persist_mask_for",
    "efficiency_with", "efficiency_without", "expected_overhead",
    "persist_overhead_fraction", "scale_mtbf", "tau_threshold",
    "POLICIES", "FailureTrace", "PoissonTrace", "RecomputeProfile",
    "SimResult", "WeibullTrace", "efficiency_frontier", "optimize_interval",
    "scaled_trace", "simulate_policy", "trace_from_spec",
    "ArrivalProcess", "FleetConfig", "FleetResult", "ServiceModel",
    "fleet_frontier", "simulate_fleet",
    "young_interval", "EasyCrashManager", "FlushPolicy", "flatten_state",
    "unflatten_state", "BatchedKernel", "IterativeApp", "Region", "State",
    "VerifyResult",
    "select_objects", "select_regions", "spearman",
    "CampaignSpec", "RoundsResult", "WorkflowConfig", "WorkflowOrchestrator",
    "WorkflowResult", "run_workflow",
    "AdaptiveReport", "RegionEvidence", "SequentialConfig", "StaticPriorSampler",
    "effective_sample_size", "final_rate_interval", "selection_invariant",
    "shard_rounds", "weighted_outcome_stats", "wilson_interval",
]
