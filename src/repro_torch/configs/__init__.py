"""Architecture registry and the ported architectures' configs."""
from repro_torch.configs.registry import (ARCHS, ArchSpec, ShapeCell,
                                          all_arch_ids, get_arch)

__all__ = ["ARCHS", "ArchSpec", "ShapeCell", "all_arch_ids", "get_arch"]
