"""train of the PyTorch/CUDA port."""
