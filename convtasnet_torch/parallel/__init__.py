"""Data, tensor and context parallelism over torch.distributed, one process
per card (counterpart of convtasnet_tpu/parallel): comm (autograd-aware
collectives), distributed (process-group start-up), mesh (the process
mesh, sharding rules, batch and parameter sharders) and context (CP)."""
