"""Models. The SGP decoder and its blocks are plain JAX; the baselines
are flax modules, imported from their own modules or through
:func:`get_model_class`, so the SGP path never needs flax."""
from sgp.models.blocks import (MLP, Dense, GroupedLinear, LinearReadout,
                               ResidualMLP, StaticGraphEmbedding)
from sgp.models.sgp import SGPModel, SGPOnlineModel


def get_model_class(name: str):
    """Model registry (``run_traffic_sgp.py:30-39`` +
    ``run_traffic_baselines.py:27-41``)."""
    if name == "sgp":
        return SGPModel
    if name == "online_sgp":
        return SGPOnlineModel
    from sgp.models.attention import TransformerModel
    from sgp.models.dcrnn import DCRNNModel
    from sgp.models.esn import ESNModel
    from sgp.models.gated_gn import (GatedGraphNetworkConvModel,
                                     GatedGraphNetworkMLPModel)
    from sgp.models.gwnet import GraphWaveNetModel
    from sgp.models.rnn import FCRNNModel, RNNModel
    from sgp.models.stgn_extra import RNNEncGCNDecModel, STCNModel, TCNModel
    return {
        "esn": ESNModel, "rnn": RNNModel, "fc_rnn": FCRNNModel,
        "dcrnn": DCRNNModel, "gwnet": GraphWaveNetModel,
        "gatedgn": GatedGraphNetworkMLPModel,
        "gatedgn_conv": GatedGraphNetworkConvModel,
        "stcn": STCNModel, "tcn": TCNModel,
        "transformer": TransformerModel, "rnn2gcn": RNNEncGCNDecModel,
    }[name]


__all__ = ["MLP", "Dense", "GroupedLinear", "LinearReadout", "ResidualMLP",
           "StaticGraphEmbedding", "SGPModel", "SGPOnlineModel",
           "get_model_class"]
