"""repro_torch.configs — the architecture registry (copies of ``src/repro/configs``)."""
