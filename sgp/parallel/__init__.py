from sgp.parallel.halo import (build_halo_spec, halo_khop,
                               shard_nodes)
from sgp.parallel.mesh import init_distributed, local_mesh, make_mesh
from sgp.parallel.sharding import (make_sharded_iid_eval,
                                   make_sharded_iid_step,
                                   make_sharded_iid_stratified_step,
                                   make_sharded_window_step,
                                   shard_batch, shard_operator,
                                   shard_params_tp, sharded_ridge,
                                   sharded_spmm)

__all__ = ["build_halo_spec", "halo_khop", "shard_nodes",
           "init_distributed", "local_mesh", "make_mesh",
           "make_sharded_iid_eval", "make_sharded_iid_step",
           "make_sharded_iid_stratified_step",
           "make_sharded_window_step", "shard_batch", "shard_operator",
           "shard_params_tp", "sharded_ridge", "sharded_spmm"]
