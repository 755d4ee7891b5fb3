from repro_torch.configs.base import ArchConfig, ShapeConfig, get_arch, list_archs, register

__all__ = ["ArchConfig", "ShapeConfig", "get_arch", "list_archs", "register"]
