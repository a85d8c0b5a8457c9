"""Global configuration.

Counterpart of the reference's global scope
(``tsl/global_scope/config.py:6-86`` + ``lib/__init__.py:1-9``): a small
dict-like config holding repository paths (data/logs/config dirs) with
auto-absolutized ``*_dir`` keys and optional TOML overrides.
"""
from __future__ import annotations

import os
import tomllib
from typing import Any

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Config(dict):
    """Dict-like config; keys ending in ``_dir`` are absolutized on set."""

    def __init__(self, **kwargs):
        super().__init__()
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key: str, value: Any):
        if isinstance(key, str) and key.endswith("_dir") \
                and isinstance(value, str):
            value = os.path.abspath(os.path.expanduser(value))
        super().__setitem__(key, value)

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e

    def update_from_toml(self, path: str):
        with open(path, "rb") as fp:
            data = tomllib.load(fp)
        for k, v in data.items():
            self[k] = v
        return self


config = Config(
    root_dir=_REPO_ROOT,
    config_dir=os.path.join(_REPO_ROOT, "configs"),
    data_dir=os.path.join(_REPO_ROOT, "datasets"),
    logs_dir=os.path.join(_REPO_ROOT, "log"),
)

_user_cfg = os.path.join(_REPO_ROOT, "sgp_config.toml")
if os.path.exists(_user_cfg):
    config.update_from_toml(_user_cfg)
