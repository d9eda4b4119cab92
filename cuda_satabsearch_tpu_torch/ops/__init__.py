"""SA search: uniform stream, plain engine, CUDA kernel and its dispatch."""
