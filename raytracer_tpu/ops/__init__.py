"""Hand-written GPU kernels (Pallas) for the hot compute paths."""
