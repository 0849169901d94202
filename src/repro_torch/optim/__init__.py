"""repro_torch.optim — AdamW with clipping and the cosine schedule, and the
int8 error-feedback gradient all-reduce."""
from repro_torch.optim.adamw import (  # noqa
    AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm,
)
