"""coala_gnn_tpu_torch — the PyTorch / CUDA port of coala_gnn_tpu.

A second package beside the JAX one (which stays as the reference the port
is tested against), for one NVIDIA H100 (Hopper, sm_90a). Module paths and
names mirror ``coala_gnn_tpu`` so each counterpart is easy to find; inside,
the code is PyTorch: ``nn.Module``s and functions on tensors, an explicit
``device`` and explicit ``torch.Generator``s.

The port imports no JAX. It reuses the JAX package's JAX-free host modules
by import: ``coala_gnn_tpu.graph``, ``coala_gnn_tpu.sampling.neighbor``,
``coala_gnn_tpu.cache.host_tier`` and ``coala_gnn_tpu.utils.timers``.

Subpackages
-----------
ops       gather-SpMM (hand-written CUDA kernels: f32 / bf16 / int8 forward
          and the backward, + plain versions), aggregation, COO oracles
models    SAGE, GCN and GAT over sampled blocks
sampling  on-device fanout neighbour sampling
cache     flat and set-associative device feature caches (f32, bf16 or
          int8 rows)
parallel  ResidentTrainer: the single-device resident training step
utils     flax->torch parameter conversion, per-window generators, CUDA build
csrc      CUDA C++ sources, built with nvcc at first use
"""

__version__ = "0.1.0"
