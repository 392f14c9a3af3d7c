"""repro_torch.cache — the flat-state cache policies, batched over lanes
(port of :mod:`repro.cache`'s flat engine), the replay grid, the Mattson
LRU sweep and delayed-hit classification."""
