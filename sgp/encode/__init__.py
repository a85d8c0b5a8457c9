from sgp.encode.reservoir import Reservoir, ReservoirLayerParams
from sgp.encode.graph_reservoir import GraphESN
from sgp.encode.spatial import (prepare_propagation_graphs,
                                sgp_spatial_embedding,
                                sgp_spatial_support)
from sgp.encode.encoders import (GESNEncoder, SGPEncoder,
                                 SGPSpatialEncoder, SGPTemporalEncoder,
                                 build_streaming_ops, get_encoder_class,
                                 streaming_encode)
from sgp.encode.encode_dataset import encode_dataset

__all__ = [
    "Reservoir", "ReservoirLayerParams", "GraphESN",
    "prepare_propagation_graphs", "sgp_spatial_embedding",
    "sgp_spatial_support", "GESNEncoder", "SGPEncoder", "SGPSpatialEncoder",
    "SGPTemporalEncoder", "get_encoder_class", "encode_dataset", "streaming_encode",
    "build_streaming_ops",
]
