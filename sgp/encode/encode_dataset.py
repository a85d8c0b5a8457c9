"""Whole-series encoder precompute and dataset rewiring.

Counterpart of ``lib/utils.py:10-47`` (``encode_dataset``): pull the
scaled series (+ optionally exogenous) as ``[T, N, F]``, run the
training-free encoder over the whole series once, store the result as
covariate ``encoded_x`` and rewire the input map —

    x <- encoded_x
    u <- (u if exogenous not encoded) + (scaled raw data if keep_raw)

Supports an on-disk cache (``.npz``) like the reference's
``save_path`` and chunked spatial streaming for encodings larger than
device memory.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from sgp.data.spatiotemporal import SpatioTemporalDataset
from sgp.utils.logging import logger


def encoder_input_array(dataset: SpatioTemporalDataset,
                        encode_exogenous: bool) -> jnp.ndarray:
    """Assemble the encoder input series ``[T, N, F]``: the scaled
    target plus (optionally) the exogenous covariates, node-broadcast
    (``lib/utils.py:17-24``). Shared by the precompute path and the
    streaming/stratified runner paths so their encoder inputs cannot
    diverge."""
    prev_keys = list(dataset.input_keys)
    keys = ["target_scaled"]
    if encode_exogenous:
        keys += [k for k in dataset.exog_keys if k in dataset.covariates]
    dataset.set_input_keys(keys)
    x = jnp.asarray(dataset.input_array())
    dataset.set_input_keys(prev_keys)
    return x


def rewire_exog_keys(dataset: SpatioTemporalDataset,
                     encode_exogenous: bool, keep_raw: bool) -> None:
    """Post-encode decoder-exogenous rewiring (``lib/utils.py:40-46``):
    ``u <- (exog if not already encoded) + (scaled raw if keep_raw)``."""
    exog = [] if encode_exogenous else \
        [k for k in dataset.exog_keys if k in dataset.covariates]
    if keep_raw:
        exog = exog + ["target_scaled"]
    dataset.exog_keys = exog


def encode_dataset(dataset: SpatioTemporalDataset,
                   encoder,
                   encode_exogenous: bool = True,
                   keep_raw: bool = False,
                   save_path: Optional[str] = None,
                   time_chunk: Optional[int] = None,
                   device_resident: bool = False,
                   store_dtype: Optional[str] = None
                   ) -> SpatioTemporalDataset:
    """Encode, attach ``encoded_x``, rewire input/exog keys. Returns the
    (mutated) dataset; the encode wall-clock is logged — it is one of the
    headline performance numbers (BASELINE.md).

    ``device_resident=True`` keeps the encoding in HBM as a jax array —
    batches gather from it on-device. Host residency is only needed
    when the encoding exceeds device memory.
    """
    if save_path is not None and os.path.exists(save_path):
        encoded = np.load(save_path)["encoded_x"]
        if store_dtype is not None:
            encoded = encoded.astype(store_dtype)
        if device_resident:
            encoded = jnp.asarray(encoded)  # back into HBM
        logger.info(f"Loaded cached encoding from {save_path}")
    else:
        x = encoder_input_array(dataset, encode_exogenous)

        start = time.time()
        enc_kwargs = {}
        if time_chunk is not None:
            enc_kwargs["time_chunk"] = time_chunk
        if store_dtype is not None:
            # e.g. 'bfloat16': halves the HBM footprint of the stored
            # encoding (decoder training is robust to bf16 features);
            # applied per-chunk inside the encoder so the full-width f32
            # expansion never materializes at once
            enc_kwargs["out_dtype"] = store_dtype
        import inspect
        sig = inspect.signature(encoder.__call__)
        supported = {k: v for k, v in enc_kwargs.items()
                     if k in sig.parameters}
        encoded = encoder(x, dataset.graph, **supported)
        if store_dtype is not None and "out_dtype" not in supported:
            encoded = encoded.astype(store_dtype)
        if device_resident:
            import jax
            encoded = jax.block_until_ready(jnp.asarray(encoded))
        else:
            encoded = np.asarray(encoded)
        elapsed = time.time() - start
        logger.info(f"Dataset encoded in {elapsed:.1f}s "
                    f"-> encoded_x {encoded.shape}")
        if save_path is not None:
            # device_resident encodings transfer to host once here — an
            # explicit opt-in via save_path (slow on a remote device link)
            os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
            np.savez(save_path, encoded_x=np.asarray(encoded))

    dataset.add_covariate("encoded_x", encoded, pattern="t n c")
    dataset.set_input_keys(["encoded_x"])
    rewire_exog_keys(dataset, encode_exogenous, keep_raw)
    return dataset
