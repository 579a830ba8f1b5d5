"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the program and take only the benchmark's inputs and weights."""
