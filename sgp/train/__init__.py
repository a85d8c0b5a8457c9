from sgp.train.metrics import (MaskedMetrics, masked_mae, masked_mape,
                               masked_mre, masked_mse, masked_rmse)
from sgp.train.predictor import Predictor
from sgp.train.ridge import ridge_regression, closed_form_readout

__all__ = ["MaskedMetrics", "masked_mae", "masked_mape", "masked_mre",
           "masked_mse", "masked_rmse", "Predictor", "ridge_regression",
           "closed_form_readout"]
