"""A narrow ``bonito_tx_crf`` config for the port's CPU tests: Bonito's
v5 stem strides and kernels, chunk geometry and CRF head at small widths
(``d_model`` 64, 2 heads, 2 layers, feed-forward 128, window (7, 8)).
No torch at module level (see ``tests/torch_one_cpu.py``)."""

import copy

STEM = [(1, 4, 5, 1, 2), (4, 4, 5, 1, 2), (4, 8, 9, 3, 4), (8, 8, 9, 2, 4),
        (8, 64, 5, 2, 2)]

MODEL = {
    "type": "bonito_tx_crf",
    "stem": [{"insize": i, "size": o, "winlen": k, "stride": s,
              "padding": p} for i, o, k, s, p in STEM],
    "encoder": {"d_model": 64, "nhead": 2, "dim_feedforward": 128,
                "num_layers": 2, "deepnorm_alpha": 1.4142135,
                "deepnorm_beta": 0.5, "attn_window": [7, 8],
                "rotary_base": 10000.0, "norm_eps": 1e-5},
    "upsample": {"scale_factor": 2},
    "crf": {"n_base": 4, "state_len": 5, "scale": 5.0, "blank_score": 2.0},
}

CONFIG = {"model": MODEL,
          "basecaller": {"chunksize": 12288, "overlap": 600}}


def config(**crf) -> dict:
    """The narrow config, its CRF section updated with ``crf``."""
    cfg = copy.deepcopy(CONFIG)
    cfg["model"]["crf"].update(crf)
    return cfg
