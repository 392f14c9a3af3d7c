"""repro_torch.kernels — the hand-written CUDA kernels for Hopper
(``csrc/*.cu``), their wrappers and their plain PyTorch versions.

Nothing is built or loaded at import time: :mod:`repro_torch.kernels._build`
compiles the sources with ``nvcc`` at the first launch on the card."""
