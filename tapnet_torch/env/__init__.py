"""env of the PyTorch/CUDA port."""
