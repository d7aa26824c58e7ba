"""PyTorch/CUDA port of GANDSE (see README "PyTorch/CUDA port")."""
