"""training of the PyTorch/CUDA port: optimizers, the two train steps, the
shared loop, checkpoints."""
