from coala_gnn_tpu_torch.coloring.coloring import (
    DEFAULT_TOPK,
    GLOBAL_MAX_HOP,
    GLOBAL_SAMPLING_RATE,
    ColorMetadata,
    color_affinity,
    color_graph,
    color_graph_from_seeds,
    generate_color_metadata,
    load_color_metadata,
    save_color_metadata,
)

__all__ = [
    "ColorMetadata",
    "color_graph",
    "color_graph_from_seeds",
    "color_affinity",
    "generate_color_metadata",
    "save_color_metadata",
    "load_color_metadata",
    "GLOBAL_MAX_HOP",
    "GLOBAL_SAMPLING_RATE",
    "DEFAULT_TOPK",
]
