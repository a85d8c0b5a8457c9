from sgp.data.datasets.base import TabularDataset
from sgp.data.datasets.synthetic import SyntheticDiffusion
from sgp.data.datasets.metr_la import MetrLA
from sgp.data.datasets.pems_bay import PemsBay
from sgp.data.datasets.pv_us import PvUS
from sgp.data.datasets.cer_en import CEREn

__all__ = ["TabularDataset", "SyntheticDiffusion", "MetrLA", "PemsBay",
           "PvUS", "CEREn"]
