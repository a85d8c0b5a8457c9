"""sgp — a JAX framework for scalable spatiotemporal GNNs.

A from-scratch JAX/XLA implementation of the SGP model family
(training-free echo-state + graph-shift-operator encoder, sampled MLP
decoder) with the capabilities of the Graph-Machine-Learning-Group/sgp
reference (AAAI 2023):

- spatial propagation runs as dense matmuls, or block-sparse / segment
  SpMM beyond the dense size cutoff;
- the reservoir time-scan is a single `jax.lax.scan` jitted once;
- multi-device scaling via `jax.sharding.Mesh` + shard_map (node-sharded
  propagation, data-parallel sampled decoder training).
"""

__version__ = "0.1.0"

epsilon = 1e-8

from sgp.utils.config import config  # noqa: E402,F401
from sgp.utils.logging import logger  # noqa: E402,F401


def _set_compile_cache():
    """Keep JAX's persistent compile cache at ``<checkout>/.jax_cache``
    unless one is configured already (JAX reads
    ``JAX_COMPILATION_CACHE_DIR`` itself). CPU-only runs, such as the
    tests, keep no cache."""
    import os

    import jax
    if jax.config.jax_compilation_cache_dir \
            or jax.config.jax_platforms == "cpu":
        return
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache"))


_set_compile_cache()
