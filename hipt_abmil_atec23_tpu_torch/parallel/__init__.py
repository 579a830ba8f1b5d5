"""Device-mesh parallelism on torch.distributed: instance-axis (sequence-
parallel) sharding of one full bag, its trainer, and process-group set-up."""
