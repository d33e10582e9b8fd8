"""Offline color-metadata generation: the port's counterpart of
``examples/generate_colors.py``, with its flags and defaults (hop 10, rate
0.005, top-k 10). Colors the graph from its train set on the host
(``coloring/``, the native library) and writes ``color.npy`` /
``topk.npy`` / ``score.npy`` / ``hop.npy`` into ``--out``, which the
trainer CLI reads with ``--distribution node_color --color_dir``.

    python -m coala_gnn_tpu_torch.generate_colors --num_nodes 200000 \\
        --feature_dim 256 --out colors200k

Only the synthetic graph is ported; ``--data`` and the other dataset
flags raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import time

from coala_gnn_tpu_torch.coloring import (generate_color_metadata,
                                          save_color_metadata)
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="color metadata for --distribution node_color")
    p.add_argument("--data", type=str, default="synthetic")
    p.add_argument("--path", type=str, default="")
    p.add_argument("--dataset_size", type=str, default="tiny")
    p.add_argument("--num_classes", type=int, default=16)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--max_hop", type=int, default=10)
    p.add_argument("--sampling_rate", type=float, default=0.005)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_nodes", type=int, default=100_000)
    p.add_argument("--avg_degree", type=int, default=15)
    p.add_argument("--feature_dim", type=int, default=128)
    return p.parse_args(argv)


def main(argv=None):
    """Prints the JAX script's two lines; returns the metadata."""
    args = parse_args(argv)
    if (args.data != "synthetic" or args.path
            or args.dataset_size != "tiny"):
        raise NotImplementedError(
            "real datasets (--data, --path, --dataset_size) are not ported "
            "yet: ROADMAP.md queue A, \"the real datasets\"")
    ds = synthetic_graph(num_nodes=args.num_nodes,
                         avg_degree=args.avg_degree,
                         feature_dim=args.feature_dim,
                         num_classes=args.num_classes, seed=args.seed)
    t0 = time.perf_counter()
    meta = generate_color_metadata(ds.graph, ds.train_idx,
                                   max_hop=args.max_hop,
                                   base_rate=args.sampling_rate,
                                   topk=args.topk, seed=args.seed)
    dt = time.perf_counter() - t0
    colored = (meta.color > 0).mean()
    print(f"colored {ds.graph.num_nodes} nodes ({colored:.1%} covered) into "
          f"{meta.num_colors} colors in {dt:.2f}s")
    save_color_metadata(meta, args.out)
    print(f"wrote color.npy/topk.npy/score.npy/hop.npy to {args.out}")
    return meta


if __name__ == "__main__":
    main()
