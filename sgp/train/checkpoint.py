"""Train-state checkpointing for restartable training.

SURVEY.md §5.3/5.4: the reference recovers only best weights via
Lightning's ModelCheckpoint; this build adds *restartability* —
params + optimizer state + sampler RNG + progress serialized together,
so a killed run resumes deterministically (designed for restart, not
in-flight elasticity). Pytrees are stored as numpy archives of their
leaves keyed by tree path (:func:`tree_to_bytes`).
"""
from __future__ import annotations

import io
import os
import pickle
import threading
from typing import Any, Dict, Optional

import jax
import numpy as np


def tree_to_bytes(tree: Any) -> bytes:
    """A numpy ``.npz`` archive of the tree's leaves, keyed by path."""
    buf = io.BytesIO()
    np.savez(buf, **{jax.tree_util.keystr(p): np.asarray(v) for p, v in
                     jax.tree_util.tree_flatten_with_path(tree)[0]})
    return buf.getvalue()


def tree_from_bytes(template: Any, data: bytes) -> Any:
    """Inverse of :func:`tree_to_bytes` into ``template``'s structure.
    Raises if a path is missing or extra, or a shape differs."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        stored, leaves = set(z.files), []
        for p, t in flat:
            key = jax.tree_util.keystr(p)
            if key not in stored:
                raise ValueError(f"checkpoint has no leaf {key}")
            stored.discard(key)
            a = z[key]
            if a.dtype.kind == "V":   # ml_dtypes (bfloat16) load as raw
                a = a.view(np.dtype(t.dtype))
            if a.shape != np.shape(t):
                raise ValueError(f"leaf {key}: stored shape {a.shape} "
                                 f"!= template {np.shape(t)}")
            leaves.append(a)
    if stored:
        raise ValueError(f"checkpoint leaves not in the template: "
                         f"{sorted(stored)}")
    return jax.tree_util.tree_unflatten(treedef, leaves)


def model_config(model) -> Dict[str, str]:
    """Hyperparameter fingerprint of a model (its dataclass
    fields, repr'd) — stored in checkpoints and asserted on reload, the
    parity of the reference's hparam-match check when loading a model
    from a checkpoint (``tsl/predictors/base_predictor.py:89-96``)."""
    import dataclasses
    out = {"__class__": type(model).__name__}
    for f in dataclasses.fields(model):
        if f.name in ("parent", "name"):
            continue
        out[f.name] = repr(getattr(model, f.name))
    return out


def check_model_config(stored: Dict[str, str], model):
    """Raise if the checkpoint's model config mismatches the live model."""
    live = model_config(model)
    mismatched = {k: (stored.get(k), live.get(k))
                  for k in set(stored) | set(live)
                  if stored.get(k) != live.get(k)}
    if mismatched:
        raise ValueError(
            "checkpoint model config mismatch (stored vs live): "
            f"{mismatched}")


def save_train_state(path: str, params: Any, opt_state: Any = None,
                     rng=None, extra: Optional[Dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {
        "params": tree_to_bytes(params),
        "opt_state": None if opt_state is None
        else tree_to_bytes(opt_state),
        "rng": None if rng is None else np.asarray(rng),
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        pickle.dump(state, fp)
    os.replace(tmp, path)  # atomic — a crash mid-write keeps the old ckpt


class AsyncCheckpointer:
    """Background checkpoint writer.

    jax arrays are immutable, so a checkpoint's device->host fetch and
    serialization can run on a worker thread while the step loop keeps
    training on NEW buffers — no copy or synchronization is needed
    beyond holding the references, so the step loop does not stall for
    the device->host transfer at every ``--checkpoint-every``.

    At most one save is in flight: a new :meth:`save` joins the
    previous one first (a writer slower than the save cadence degrades
    to the synchronous behavior, never to a queue). A writer exception
    is re-raised at the next :meth:`save`/:meth:`wait` so failures
    cannot pass silently. Call :meth:`wait` before reading the file or
    exiting."""

    def __init__(self, save_fn=None):
        self._save_fn = save_fn or save_run_state
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, *args, **kwargs):
        self.wait()

        def run():
            try:
                self._save_fn(*args, **kwargs)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def save_run_state(path: str, model, params, opt_state, rng,
                   epoch: int, best_loss: float, best_params,
                   elapsed_s: float = 0.0,
                   train_config: Optional[Dict] = None):
    """One ATOMIC file for a restartable runner epoch: current
    params/opt/RNG plus the best-so-far params and progress — a kill
    can never leave 'current' and 'best' out of sync (they live in the
    same ``os.replace``). ``train_config`` records the training
    hyperparameters (lr, batch size, ...) so a resume under different
    training settings fails loudly instead of silently breaking the
    exact-run semantics."""
    save_train_state(path, params, opt_state, rng, extra={
        "epoch": epoch, "best_loss": float(best_loss),
        "model_config": model_config(model),
        "train_config": train_config or {},
        "best_params": tree_to_bytes(best_params),
        "elapsed_s": float(elapsed_s)})


def restore_run_state(path: str, model, params_template,
                      opt_state_template,
                      train_config: Optional[Dict] = None):
    """Counterpart of :func:`save_run_state`. Returns ``(params,
    opt_state, rng, start_epoch, best_loss, best_params, elapsed_s)``;
    raises on a model- or train-config mismatch."""
    params, opt_state, rng, extra = load_train_state(
        path, params_template, opt_state_template, model=model)
    stored_tc = extra.get("train_config", {})
    if train_config:
        mismatched = {k: (stored_tc.get(k), v)
                      for k, v in train_config.items()
                      if stored_tc.get(k) != v}
        if mismatched:
            raise ValueError(
                "checkpoint train config mismatch (stored vs live): "
                f"{mismatched}")
    best_params = tree_from_bytes(params_template,
                                                extra["best_params"])
    return (params, opt_state, rng, extra["epoch"] + 1,
            extra["best_loss"], best_params, extra.get("elapsed_s", 0.0))


def load_train_state(path: str, params_template: Any,
                     opt_state_template: Any = None, model=None):
    """Load a :func:`save_train_state` file into the templates; with
    ``model``, first raise if its stored config differs."""
    with open(path, "rb") as fp:
        state = pickle.load(fp)
    if model is not None and "model_config" in state["extra"]:
        check_model_config(state["extra"]["model_config"], model)
    params = tree_from_bytes(params_template,
                                           state["params"])
    opt_state = None
    if state["opt_state"] is not None and opt_state_template is not None:
        opt_state = tree_from_bytes(opt_state_template,
                                                  state["opt_state"])
    rng = None if state["rng"] is None else jax.numpy.asarray(state["rng"])
    return params, opt_state, rng, state["extra"]
