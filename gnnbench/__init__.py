"""The benchmark of the PyTorch and CUDA port (``coala_gnn_tpu_torch``):
one command runs one cell of ``BENCHMARK.json`` once (``gnnbench/run.py``).
Nothing here imports JAX or the JAX package."""
