from repro_torch.lowering.lower import (LoweredPlan, LoweredStage,
                                       check_plan_mesh, check_serve_plan,
                                       check_train_plan, lower_plan,
                                       plan_mesh, plan_mesh_axes,
                                       serve_exec_cfg, shard_tensor,
                                       stage_exec_config, train_exec_cfg)
from repro_torch.lowering.memory import (MEMORY_REL_TOL, MemoryReport,
                                        StageMemory, memory_consistency)

__all__ = ["LoweredPlan", "LoweredStage", "MEMORY_REL_TOL", "MemoryReport",
           "StageMemory", "check_plan_mesh", "check_serve_plan",
           "check_train_plan", "lower_plan", "memory_consistency",
           "plan_mesh", "plan_mesh_axes", "serve_exec_cfg", "shard_tensor",
           "stage_exec_config", "train_exec_cfg"]
