"""A narrow ``bonito_lstm_crf`` config for the port's CPU tests: Bonito's
v4 stem kernels and strides (winlen 19, stride 6), chunk geometry (9,996
samples overlapping by 498) and CRF head at small widths (convolutions
of 4 and 32 channels, 3 LSTM layers of 32, the first and the last reversed).  No
torch at module level (see ``tests/torch_one_cpu.py``)."""

import copy

STEM = [(1, 4, 5, 1, 2), (4, 4, 5, 1, 2), (4, 32, 19, 6, 9)]

MODEL = {
    "type": "bonito_lstm_crf",
    "stem": [{"insize": i, "size": o, "winlen": k, "stride": s,
              "padding": p} for i, o, k, s, p in STEM],
    "lstm": {"size": 32, "num_layers": 3},
    "crf": {"n_base": 4, "state_len": 5, "scale": 5.0, "blank_score": 2.0,
            "bias": True},
}

CONFIG = {"model": MODEL,
          "basecaller": {"chunksize": 9996, "overlap": 498}}


def config() -> dict:
    """A fresh copy of the narrow config."""
    return copy.deepcopy(CONFIG)
