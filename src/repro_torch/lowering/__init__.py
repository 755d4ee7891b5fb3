from repro_torch.lowering.lower import (check_plan_mesh, serve_exec_cfg,
                                       stage_exec_config, train_exec_cfg)

__all__ = ["check_plan_mesh", "serve_exec_cfg", "stage_exec_config",
           "train_exec_cfg"]
