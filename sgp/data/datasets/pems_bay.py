"""PEMS-BAY traffic dataset loader (``tsl/datasets/pems_bay.py:12-120``):
325 Bay Area sensors, 5-min, Jan-May 2017 (52,116 steps). Local files
only (no egress): ``<data_dir>/PemsBay/pems_bay.h5`` + ``pems_bay_dist.npy``.
"""
from sgp.data.datasets.metr_la import _PemsBayBase


class PemsBay(_PemsBayBase):
    def __init__(self, root=None, mask_zeros: bool = True):
        self.mask_zeros = mask_zeros
        super().__init__(root=root)
