"""The central spatiotemporal data model.

Redesign of the reference's ``SpatioTemporalDataset``
(``tsl/data/spatiotemporal_dataset.py:24-897``). The torch version builds
per-sample ``Data`` objects in DataLoader worker processes and collates
them; here the whole series lives as contiguous host arrays and **batch
assembly is one vectorized gather** over window/horizon step indices —
no worker processes, no collate, jit-friendly output, and the same gather
runs device-side when the arrays fit HBM.

Data layout: target ``[T, N, C]`` float32, mask ``[T, N, C]`` bool,
covariates with patterns ``'t n c'`` (node-level) / ``'t c'`` (global),
an optional :class:`~sgp.graph.Graph` and a datetime index.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sgp.data.scalers import Scaler, ScalerParams
from sgp.data.windowing import Windowing
from sgp.graph.sparse import Graph


def _is_device(arr) -> bool:
    import jax
    return isinstance(arr, jax.Array)


def _xp(*arrays):
    """numpy or jax.numpy depending on residency. Device-resident
    covariates (e.g. the encoded features) must never round-trip to the
    host — the host link is orders of magnitude slower than device
    memory."""
    if any(_is_device(a) for a in arrays if a is not None):
        import jax.numpy as jnp
        return jnp
    return np


@dataclasses.dataclass
class Covariate:
    value: "np.ndarray"  # np.ndarray or jax.Array (device-resident)
    pattern: str  # 't n c', 't c', 'n c'


class Batch(dict):
    """A plain dict of arrays with attribute access (x, y, mask, u, ...)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


class SpatioTemporalDataset:
    """Windowed spatiotemporal dataset over host arrays.

    Args:
        target: ``[T, N, C]`` (or ``[T, N]``, auto-expanded) observations.
        index: optional ``[T]`` ``np.datetime64`` timestamps.
        mask: optional ``[T, N, C]`` validity mask.
        graph: optional connectivity.
        covariates: dict name -> array; patterns inferred from ndim
            (3 -> 't n c', 2 -> 't c') or given explicitly via tuples
            ``(array, pattern)``.
        windowing: window/horizon spec (see :class:`Windowing`).
    """

    def __init__(self, target: np.ndarray,
                 index: Optional[np.ndarray] = None,
                 mask: Optional[np.ndarray] = None,
                 graph: Optional[Graph] = None,
                 covariates: Optional[Dict] = None,
                 windowing: Optional[Windowing] = None,
                 precision: np.dtype = np.float32):
        target = np.asarray(target, precision)
        if target.ndim == 2:
            target = target[..., None]
        assert target.ndim == 3, "target must be [T, N, C]"
        self.target = target
        self.index = None if index is None else np.asarray(index)
        if mask is None:
            mask = np.ones_like(target, bool)
        else:
            mask = np.asarray(mask, bool)
            if mask.ndim == 2:
                mask = mask[..., None]
            mask = np.broadcast_to(mask, target.shape).copy()
        self.mask = mask
        self.graph = graph
        self.windowing = windowing or Windowing()
        self.covariates: Dict[str, Covariate] = {}
        for name, val in (covariates or {}).items():
            if isinstance(val, tuple):
                self.add_covariate(name, val[0], val[1])
            else:
                self.add_covariate(name, val)
        # scaling state
        self.scalers: Dict[str, Scaler] = {}
        self._target_scaled: Optional[np.ndarray] = None
        # which keys form the model input x (rewired after encoding, cf.
        # ``lib/utils.py:40-46``)
        self.input_keys: List[str] = ["target"]
        self.exog_keys: List[str] = [
            k for k in (covariates or {}) if k.startswith("u")]

    # -- shape properties --------------------------------------------------
    @property
    def n_steps(self) -> int:
        return self.target.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.target.shape[1]

    @property
    def n_channels(self) -> int:
        return self.target.shape[2]

    @property
    def horizon(self) -> int:
        return self.windowing.horizon

    def __len__(self) -> int:
        return len(self.indices())

    def indices(self) -> np.ndarray:
        return self.windowing.indices(self.n_steps)

    # -- covariates --------------------------------------------------------
    def add_covariate(self, name: str, value: np.ndarray,
                      pattern: Optional[str] = None):
        if not _is_device(value):
            value = np.asarray(value)
        if pattern is None:
            if value.ndim == 3:
                pattern = "t n c"
            elif value.ndim == 2:
                pattern = "t c"
            else:
                raise ValueError(
                    f"cannot infer pattern for {name} with ndim {value.ndim}")
        if pattern in ("t n c", "t c"):
            assert value.shape[0] == self.n_steps, \
                f"{name}: time dim {value.shape[0]} != {self.n_steps}"
        if pattern == "t n c":
            assert value.shape[1] == self.n_nodes
        if not _is_device(value):
            value = value.astype(np.float32, copy=False)
        self.covariates[name] = Covariate(value, pattern)

    # -- scaling -----------------------------------------------------------
    def fit_scaler(self, scaler: Scaler,
                   step_index: Optional[np.ndarray] = None):
        """Fit the target scaler on (a slice of) the series — the train
        slice, mask-aware (``spatiotemporal_datamodule.py:151-159``) —
        then cache the scaled series."""
        x = self.target if step_index is None else self.target[step_index]
        m = self.mask if step_index is None else self.mask[step_index]
        scaler.fit(x, mask=m if not m.all() else None)
        self.scalers["target"] = scaler
        self._target_scaled = scaler.transform(self.target).astype(
            self.target.dtype)
        return self

    @property
    def target_scaled(self) -> np.ndarray:
        if self._target_scaled is None:
            return self.target
        return self._target_scaled

    def scaler_params(self) -> ScalerParams:
        if "target" in self.scalers:
            return self.scalers["target"].params()
        import jax.numpy as jnp
        return ScalerParams(jnp.zeros(1), jnp.ones(1))

    # -- input assembly ----------------------------------------------------
    def set_input_keys(self, keys: Sequence[str]):
        for k in keys:
            assert k in ("target", "target_scaled") or k in self.covariates, k
        self.input_keys = list(keys)

    def _key_array(self, key: str) -> Tuple[np.ndarray, str]:
        if key == "target":
            return self.target_scaled, "t n c"
        if key == "target_scaled":
            return self.target_scaled, "t n c"
        cov = self.covariates[key]
        return cov.value, cov.pattern

    def input_array(self) -> np.ndarray:
        """Concatenate input keys channel-wise to ``[T, N, Cin]``,
        broadcasting global ('t c') covariates over nodes."""
        parts = []
        for k in self.input_keys:
            arr, pattern = self._key_array(k)
            if pattern == "t c":
                arr = _xp(arr).broadcast_to(
                    arr[:, None, :],
                    (arr.shape[0], self.n_nodes, arr.shape[-1]))
            parts.append(arr)
        if len(parts) == 1:
            return parts[0]
        return _xp(*parts).concatenate(parts, axis=-1)

    def exog_array(self) -> Optional[np.ndarray]:
        """Exogenous ``u``: ``[T, F]`` if all parts are global, else
        node-level ``[T, N, F]`` (parts broadcast as needed). May include
        ``target_scaled`` — the post-encoding ``keep_raw`` rewiring makes
        the scaled raw series the exogenous input (``lib/utils.py:40-46``).
        """
        parts = [self._key_array(k) for k in self.exog_keys
                 if k in self.covariates
                 or k in ("target", "target_scaled")]
        if not parts:
            return None
        if any(p == "t n c" for _, p in parts):
            vals = [arr if p == "t n c" else _xp(arr).broadcast_to(
                arr[:, None, :], (arr.shape[0], self.n_nodes, arr.shape[-1]))
                for arr, p in parts]
        else:
            vals = [arr for arr, _ in parts]
        if len(vals) == 1:
            return vals[0]
        return _xp(*vals).concatenate(vals, axis=-1)

    # -- batch gather ------------------------------------------------------
    def gather_batch(self, item_idx: np.ndarray,
                     node_index: Optional[np.ndarray] = None) -> Batch:
        """Assemble a batch for window-start items ``item_idx [B]``.

        One fancy-indexing gather per tensor (the vectorized counterpart
        of ``SpatioTemporalDataset.get`` + ``static_graph_collate``).
        """
        w = self.windowing
        starts = self.indices()[np.asarray(item_idx)]
        w_steps = starts[:, None] + w.window_offsets()[None, :]   # [B, W]
        h_steps = starts[:, None] + w.horizon_offsets()[None, :]  # [B, H]
        x_full = self.input_array()
        x = x_full[w_steps]               # [B, W, N, Cin]
        y = self.target[h_steps]          # [B, H, N, C]
        m = self.mask[h_steps]
        batch = Batch(x=x, y=y, mask=m)
        u = self.exog_array()
        if u is not None:
            batch["u"] = u[w_steps]       # [B, W, F] or [B, W, N, F]
            batch["u_horizon"] = u[h_steps]
        if node_index is not None:
            node_index = np.asarray(node_index)
            for k in ("x", "y", "mask"):
                batch[k] = batch[k][..., node_index, :] \
                    if batch[k].ndim == 4 else batch[k]
            if u is not None and batch["u"].ndim == 4:
                batch["u"] = batch["u"][..., node_index, :]
                batch["u_horizon"] = batch["u_horizon"][..., node_index, :]
            batch["node_index"] = node_index
        return batch

    def gather_iid_batch(self, step_idx: np.ndarray,
                         node_idx: np.ndarray) -> Batch:
        """IID (time, node)-pair batch (``lib/datasets/iid_dataset.py:
        57-99``): window inputs at the sampled (step, node), horizon
        targets at the lagged offsets; window==1 in all IID configs so
        ``x`` is ``[B, Cin]``.
        """
        w = self.windowing
        starts = np.asarray(step_idx)
        node_idx = np.asarray(node_idx)
        w_steps = starts[:, None] + w.window_offsets()[None, :]   # [B, W]
        h_steps = starts[:, None] + w.horizon_offsets()[None, :]
        x_full = self.input_array()
        x = x_full[w_steps, node_idx[:, None]]   # [B, W, Cin]
        y = self.target[h_steps, node_idx[:, None]]  # [B, H, C]
        m = self.mask[h_steps, node_idx[:, None]]
        batch = Batch(x=x, y=y, mask=m, node_index=node_idx)
        u = self.exog_array()
        if u is not None:
            if u.ndim == 3:
                batch["u"] = u[w_steps, node_idx[:, None]]
                batch["u_horizon"] = u[h_steps, node_idx[:, None]]
            else:
                batch["u"] = u[w_steps]
                batch["u_horizon"] = u[h_steps]
        return batch

    # -- slicing -----------------------------------------------------------
    def reduce(self, step_index: np.ndarray) -> "SpatioTemporalDataset":
        """New dataset restricted to ``step_index`` (contiguous slice or
        index array), as in ``spatiotemporal_dataset.py:707-771``."""
        sub = SpatioTemporalDataset(
            self.target[step_index],
            index=None if self.index is None else self.index[step_index],
            mask=self.mask[step_index],
            graph=self.graph,
            windowing=self.windowing)
        for name, cov in self.covariates.items():
            val = cov.value[step_index] if cov.pattern.startswith("t") \
                else cov.value
            sub.covariates[name] = Covariate(val, cov.pattern)
        sub.scalers = self.scalers
        if self._target_scaled is not None:
            sub._target_scaled = self._target_scaled[step_index]
        sub.input_keys = list(self.input_keys)
        sub.exog_keys = list(self.exog_keys)
        return sub

    # -- persistence & windowing context ----------------------------------
    def save(self, path: str):
        """Persist arrays + windowing (``spatiotemporal_dataset.py:
        869-887`` torch.save counterpart, as npz)."""
        import dataclasses as _dc
        arrays = {"target": self.target, "mask": self.mask}
        if self.index is not None:
            arrays["index"] = self.index.astype("datetime64[ns]"
                                                ).astype(np.int64)
        meta = {"windowing": _dc.asdict(self.windowing),
                "input_keys": self.input_keys,
                "exog_keys": self.exog_keys, "cov": {}}
        for name, cov in self.covariates.items():
            arrays[f"cov_{name}"] = np.asarray(cov.value)
            meta["cov"][name] = cov.pattern
        if self.graph is not None:
            arrays["g_src"] = self.graph.src
            arrays["g_dst"] = self.graph.dst
            arrays["g_w"] = self.graph.weight
            meta["g_n"] = self.graph.num_nodes
        import json
        np.savez_compressed(path, __meta__=np.frombuffer(
            json.dumps(meta).encode(), np.uint8), **arrays)

    @classmethod
    def load(cls, path: str) -> "SpatioTemporalDataset":
        import json
        data = np.load(path)
        meta = json.loads(bytes(data["__meta__"]).decode())
        graph = None
        if "g_src" in data:
            graph = Graph(data["g_src"], data["g_dst"], data["g_w"],
                          meta["g_n"])
        index = (data["index"].astype("datetime64[ns]")
                 if "index" in data else None)
        ds = cls(data["target"], index=index, mask=data["mask"],
                 graph=graph, windowing=Windowing(**meta["windowing"]))
        for name, pattern in meta["cov"].items():
            ds.covariates[name] = Covariate(data[f"cov_{name}"], pattern)
        ds.input_keys = meta["input_keys"]
        ds.exog_keys = meta["exog_keys"]
        return ds

    def change_windowing(self, **kwargs):
        """Context manager temporarily altering the windowing
        (``spatiotemporal_dataset.py:773-784``)."""
        import contextlib
        import dataclasses as _dc

        @contextlib.contextmanager
        def ctx():
            prev = self.windowing
            self.windowing = _dc.replace(prev, **kwargs)
            try:
                yield self
            finally:
                self.windowing = prev
        return ctx()

    def overlapping_indices(self, items_a, items_b) -> np.ndarray:
        """Items of ``a`` whose sample span overlaps any step used by
        ``b`` (``spatiotemporal_dataset.py:812-846``)."""
        steps_b = set(self.expand_item_steps(items_b).tolist())
        w = self.windowing
        starts = self.indices()
        out = []
        for i in np.asarray(items_a):
            span = range(int(starts[i]),
                         int(starts[i]) + w.sample_span)
            if any(s in steps_b for s in span):
                out.append(i)
        return np.asarray(out, np.int64)

    def expand_item_steps(self, item_idx: np.ndarray) -> np.ndarray:
        """All horizon steps covered by the given items (for splitter
        overlap handling)."""
        starts = self.indices()[np.asarray(item_idx)]
        return np.unique(
            starts[:, None] + self.windowing.horizon_offsets()[None, :])
