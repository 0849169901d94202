"""repro_torch.data — the MapReduce engine's delta streams (the LM data
helpers of ``repro.data`` are ROADMAP Queue 1 item 16b)."""
from repro_torch.data.pipeline import DeltaStream  # noqa
