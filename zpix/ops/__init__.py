"""Dense compute kernels (numpy host / JAX device)."""
