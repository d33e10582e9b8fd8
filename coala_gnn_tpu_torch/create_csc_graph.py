"""COO -> CSC preprocessing: the port's counterpart of
``examples/create_csc_graph.py``, with its flags. Reads COO edges (.npy,
[2, E] or [E, 2]), sorts them by destination (``graph.csc.coo_to_csc``)
and writes ``csc_indptr.npy`` / ``csc_indices.npy`` / ``csc_edge_ids.npy``
(plus ``csc_edge_types.npy`` for a typed graph) into ``--out``, the files
``graph.datasets.load_preprocessed`` reads (beside ``features.npy`` and
``labels.npy``, which the caller puts there).

A typed graph comes from several ``--edge_index`` files (file k's edges
get relation k) or from one file with ``--edge_types`` (an aligned int
.npy). ``--symmetrize`` adds every edge reversed; on a typed graph a
reversed edge of relation r gets relation ``num_rels + r``.

    python -m coala_gnn_tpu_torch.create_csc_graph \\
        --edge_index edge_index.npy --num_nodes 10000000 --out csc \\
        [--symmetrize]
    python -m coala_gnn_tpu_torch.create_csc_graph \\
        --edge_index cites.npy writes.npy --out csc_hetero --symmetrize
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from coala_gnn_tpu_torch.graph.csc import coo_to_csc, save_csc


def _load_coo(path: str):
    edges = np.load(path, mmap_mode="r")
    if edges.shape[0] == 2:
        return np.asarray(edges[0]), np.asarray(edges[1])
    return np.asarray(edges[:, 0]), np.asarray(edges[:, 1])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="COO edge lists -> CSC .npy")
    p.add_argument("--edge_index", type=str, nargs="+", required=True,
                   help=".npy COO edges, shape [2, E] or [E, 2]; several "
                        "files make a typed graph, file k -> relation k")
    p.add_argument("--edge_types", type=str, default="",
                   help="int .npy aligned with a single --edge_index")
    p.add_argument("--num_nodes", type=int, default=0,
                   help="0 = infer as max id + 1")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--symmetrize", action="store_true",
                   help="add reverse edges; on a typed graph they get "
                        "relation ids num_rels + r")
    return p, p.parse_args(argv)


def main(argv=None):
    """Prints the JAX script's three lines; returns the graph."""
    p, args = parse_args(argv)
    t0 = time.perf_counter()
    if len(args.edge_index) > 1 and args.edge_types:
        p.error("--edge_types only combines with a single --edge_index")
    parts = [_load_coo(f) for f in args.edge_index]
    src = np.concatenate([s for s, _ in parts])
    dst = np.concatenate([d for _, d in parts])
    ets = None
    if len(parts) > 1:
        ets = np.concatenate([np.full(len(s), k, np.int32)
                              for k, (s, _) in enumerate(parts)])
    elif args.edge_types:
        ets = np.asarray(np.load(args.edge_types, mmap_mode="r"), np.int32)
        if ets.shape != src.shape:
            p.error("--edge_types length must match the edge count")
    n = args.num_nodes or int(max(src.max(), dst.max())) + 1
    if args.symmetrize:
        if ets is not None:
            ets = np.concatenate([ets, ets + int(ets.max()) + 1])
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    print(f"loaded {len(src)} edges over {n} nodes"
          + (f", {int(ets.max()) + 1} relations" if ets is not None else "")
          + f" in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    g = coo_to_csc(src, dst, n, edge_types=ets)
    print(f"CSC build: {time.perf_counter() - t0:.1f}s")
    save_csc(g, args.out)
    print("wrote csc_indptr/csc_indices/csc_edge_ids"
          + ("/csc_edge_types" if ets is not None else "")
          + f".npy to {args.out}")
    return g


if __name__ == "__main__":
    main()
