"""Hand-written CUDA kernels for Hopper (sm_90a), their wrappers and plain
versions (``kernels``), their build (``build``), geometry and dispatch."""
