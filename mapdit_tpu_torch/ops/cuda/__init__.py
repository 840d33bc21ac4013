"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), their
wrappers, plain versions and launch counts."""
