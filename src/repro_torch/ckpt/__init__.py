from repro_torch.ckpt.checkpoint import (  # noqa
    latest_step, restore_pytree, save_pytree, CheckpointManager,
)
