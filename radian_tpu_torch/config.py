"""Configuration: the default sig2seq config as a dict, YAML on request.

Same schema and values as ``radian_tpu/configs/sig2seq.yaml`` (itself the
reference ``radian/models/sig2seq.yaml``).  The default lives in Python so
that a host without ``yaml`` can build the model; ``yaml`` is imported only
when a config path is given.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Mapping

_DEFAULT_CONFIG: dict = {
    "data": {
        "n_classes": 5,  # A, C, G, U(->T), CTC blank
        "window_size": 1024,
    },
    "train": {
        "batch_size": 32,
        "n_epochs": 1000,
        "n_folds": 10,
        "val_freq": 1,
        "opt": {
            "type": "adam",
            "adam": {
                "lr": 0.0001,
                "beta_1": 0.9,
                "beta_2": 0.999,
                "epsilon": 0.0000001,
                "amsgrad": False,
                "clipnorm": False,
                "clipvalue": False,
            },
            "sgd": {
                "lr": 0.01,
                "momentum": 0.0,
                "nesterov": False,
                "clipnorm": False,
                "clipvalue": False,
            },
            "adagrad": {"lr": 0.001},
            "cc_opt": {  # causalcall-style piecewise-decay Adam schedule
                "max_steps": 200000,
                "boundaries": [0.03, 0.07, 0.25, 0.5, 0.7],
                "init_rate": 0.004,
                "decays": [0.4, 0.2, 0.1, 0.06, 0.03, 0.01],
            },
        },
    },
    "model": {
        "relu_units": 128,
        "softmax_units": 5,
        "timesteps": 1024,
        "tcn": {
            "nb_filters": 256,
            "kernel_size": 3,
            "nb_stacks": 1,
            "dilations": [1, 2, 4, 8, 16, 32],
            "padding": "causal",
            "use_skip_connections": False,
            "dropout_rate": 0.0,
            "return_sequences": True,
            "activation": "relu",
            "kernel_initializer": "he_normal",
            "use_batch_norm": False,
        },
    },
}


class DotDict(dict):
    """A dict with attribute access, recursively applied to nested mappings."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, Mapping) and not isinstance(v, DotDict):
            return cls(v)
        if isinstance(v, list):
            return [cls._wrap(x) for x in v]
        return v

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value):
        self[name] = self._wrap(value)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, DotDict):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, DotDict) else x for x in v]
            else:
                out[k] = v
        return out

    def copy(self) -> "DotDict":
        return DotDict(copy.deepcopy(self.to_dict()))


def default_config() -> DotDict:
    return DotDict(copy.deepcopy(_DEFAULT_CONFIG))


def get_config(path: str | Path | None = None) -> DotDict:
    """Load a YAML model/train config; ``None`` gives the default."""
    if path is None:
        return default_config()
    import yaml

    with open(path) as f:
        return DotDict(yaml.safe_load(f))
