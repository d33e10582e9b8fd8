"""coala_gnn_tpu_torch — the PyTorch / CUDA port of coala_gnn_tpu.

A second package beside the JAX one (which stays as the reference the port
is tested against), for one NVIDIA H100 (Hopper, sm_90a). Module paths and
names mirror ``coala_gnn_tpu`` so each counterpart is easy to find; inside,
the code is PyTorch: ``nn.Module``s and functions on tensors, an explicit
``device`` and explicit ``torch.Generator``s.

The port stands alone: it imports neither JAX nor ``coala_gnn_tpu``. What
it needs of the JAX package's host modules it keeps as its own copies,
under the same names (``graph/csc.py``, ``graph/datasets.py``,
``sampling/neighbor.py``, ``cache/host_tier.py``, ``native/lib.py`` with
``csrc/host_native.cpp``, ``utils/timers.py``); tests/test_torch_host.py
holds them bit for bit against the originals. Its native host library and
its kernels build into ``coala_gnn_tpu_torch/_build/``.

Subpackages
-----------
ops       gather-SpMM (hand-written CUDA kernels: f32 / bf16 / int8 forward,
          the backward and adj's transpose, + plain versions),
          aggregation, COO oracles
models    SAGE, GCN and GAT over sampled blocks; the hetero RSAGE, RGCN
          and RGAT (relations stacked in one gather-SpMM call per layer)
sampling  on-device fanout neighbour sampling (CSR or the padded
          neighbour table, slot-major or deduplicated blocks); the host
          sampler (dedup and slot-major layouts); both typed on a hetero
          graph; block capacities
coloring  offline BFS graph coloring and color-affinity metadata (host,
          native), read by the node_color distribution
distribution  seed distributor (baseline, node_color greedy) and its
          pipelined scheduler
data      the host pipeline's prefetching loader and request packing
cache     flat and set-associative device feature caches (f32, bf16 or
          int8 rows); the host feature tier
graph     CSC graph (with edge types) and the synthetic dataset
native    ctypes bindings of the native host functions (sampler, greedy,
          row gather and encode)
parallel  ResidentTrainer (the resident training step); the host
          pipeline's one-device cache front, train steps and run_host
utils     flax->torch parameter and optax Adam state conversion,
          checkpoints, per-window generators, phase timers, the nvcc / g++
          build
csrc      CUDA C++ (nvcc) and host C++ (g++) sources, built at first use
train     the trainer CLI, ``python -m coala_gnn_tpu_torch.train``
generate_colors  the color metadata CLI, ``python -m
          coala_gnn_tpu_torch.generate_colors``

The coloring's names are exported here, as the JAX package's
``coala_gnn_tpu.coloring`` exports them.
"""

__version__ = "0.1.0"

from coala_gnn_tpu_torch.coloring import (  # noqa: F401
    ColorMetadata, color_affinity, color_graph, generate_color_metadata,
    load_color_metadata, save_color_metadata)
