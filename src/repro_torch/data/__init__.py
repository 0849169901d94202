"""repro_torch.data — the LM's deterministic token batches and the
MapReduce engine's delta streams."""
from repro_torch.data.pipeline import (  # noqa
    DeltaStream, LMDataConfig, lm_batch_at_step, lm_batches, synthetic_tokens,
)
