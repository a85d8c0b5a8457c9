from sgp.ops.spmm import (
    BSROperator,
    COOOperator,
    DenseOperator,
    GlobalMeanOperator,
    build_operator,
    spmm,
)
from sgp.ops.linalg import power_iteration_spectral_radius
from sgp.ops.scatter import segment_mean, segment_softmax, segment_sum

__all__ = [
    "BSROperator", "COOOperator", "DenseOperator", "GlobalMeanOperator",
    "build_operator", "spmm", "power_iteration_spectral_radius",
    "segment_mean", "segment_softmax", "segment_sum",
]
