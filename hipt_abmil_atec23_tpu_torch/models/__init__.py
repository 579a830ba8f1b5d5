"""PyTorch models of the port: DINO ViTs, HIPT_4K, CLAM_SB and the
checkpoint bridges."""
