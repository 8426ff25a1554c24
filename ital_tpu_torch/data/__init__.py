"""Dataset loaders and the simulated user."""
