from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
)
from repro_torch.optim.schedule import get_schedule, warmup_cosine, wsd

__all__ = [
    "AdamWConfig", "adamw_update", "clip_by_global_norm", "global_norm",
    "init_opt_state", "get_schedule", "warmup_cosine", "wsd",
]
