from sgp.graph.sparse import (
    Graph,
    add_self_loops,
    coalesce,
    dummy_graph,
    edge_dropout,
    k_hop_subgraph,
    normalize_adj,
    remove_self_loops,
    spgemm,
    to_undirected,
    transpose,
    weighted_degree,
)
from sgp.graph.similarities import (
    correntropy,
    gaussian_kernel,
    geographical_distance,
    pearson_similarity,
    thresholded_gaussian_kernel,
    top_k,
)

__all__ = [
    "Graph", "add_self_loops", "coalesce", "dummy_graph", "edge_dropout",
    "k_hop_subgraph",
    "normalize_adj", "remove_self_loops", "spgemm", "to_undirected",
    "transpose", "weighted_degree",
    "correntropy", "gaussian_kernel", "geographical_distance",
    "pearson_similarity", "thresholded_gaussian_kernel", "top_k",
]
