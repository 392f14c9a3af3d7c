"""repro_torch.core — the closed queueing-network models (numpy copies of
the reference), the network -> simulator-spec compiler, the closed-loop
simulator and the prong-C measurement harness."""
