"""repro_torch.training — the serving workload generator (numpy only)."""
