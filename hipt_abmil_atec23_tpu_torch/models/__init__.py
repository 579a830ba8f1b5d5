"""PyTorch models of the port: DINO ViTs, HIPT_4K, the MIL heads and the
checkpoint bridges."""
