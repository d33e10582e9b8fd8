"""Offline color-metadata generation: the port's counterpart of
``examples/generate_colors.py``, with its flags and defaults (hop 10, rate
0.005, top-k 10). Colors the graph from its train set on the host
(``coloring/``, the native library) and writes ``color.npy`` /
``topk.npy`` / ``score.npy`` / ``hop.npy`` into ``--out``, which the
trainer CLI reads with ``--distribution node_color --color_dir``.

    python -m coala_gnn_tpu_torch.generate_colors --num_nodes 200000 \\
        --feature_dim 256 --out colors200k

``--data`` picks the graph as the trainer CLI does (``train.load``): the
synthetic graph, or a dataset on disk through ``--path``,
``--dataset_size`` and ``--num_classes``.
"""

from __future__ import annotations

import argparse
import time

from coala_gnn_tpu_torch.coloring import (generate_color_metadata,
                                          save_color_metadata)


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
    from coala_gnn_tpu_torch.train import load

    args = parse_args(argv)
    ds = load(args)
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
