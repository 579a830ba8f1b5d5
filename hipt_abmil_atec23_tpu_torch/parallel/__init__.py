"""Device-mesh parallelism on torch.distributed: instance-axis (sequence-
parallel) sharding of one full bag, its trainer, fold-parallel training,
and process-group set-up."""
