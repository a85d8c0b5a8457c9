from sgp.data.scalers import (MinMaxScaler, RobustScaler, Scaler,
                              ScalerParams, StandardScaler)
from sgp.data.spatiotemporal import Batch, SpatioTemporalDataset
from sgp.data.splitters import (AtTimeStepSplitter,
                                DisjointMonthsSplitter,
                                FixedIndicesSplitter, Split, Splitter,
                                TemporalSplitter, datetime_encoded,
                                disjoint_months, indices_between)
from sgp.data.windowing import Windowing
from sgp.data.loader import IIDLoader, WindowedLoader

__all__ = [
    "MinMaxScaler", "RobustScaler", "Scaler", "ScalerParams",
    "StandardScaler", "Batch", "SpatioTemporalDataset",
    "DisjointMonthsSplitter", "disjoint_months",
    "AtTimeStepSplitter", "FixedIndicesSplitter", "Split", "Splitter",
    "TemporalSplitter", "datetime_encoded", "indices_between", "Windowing",
    "IIDLoader", "WindowedLoader",
]
