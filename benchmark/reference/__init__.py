"""The plain float32 references the benchmark judges the program's outputs
by. Plain PyTorch, written from the published R2DM code; nothing here imports
the program or JAX."""
