from repro_torch.lowering.lower import (check_plan_mesh, serve_exec_cfg,
                                       stage_exec_config)

__all__ = ["check_plan_mesh", "serve_exec_cfg", "stage_exec_config"]
