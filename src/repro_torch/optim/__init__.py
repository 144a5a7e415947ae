"""From-scratch optimizers and distributed-optimization tricks (torch)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           compressed_psum)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "compress_int8", "decompress_int8",
           "compressed_psum"]
