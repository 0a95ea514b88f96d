"""The LSTM-CRF model's plain reference
(``benchmark/core/reference_lstm_crf.py``, which the benchmark and the
port's tests hold the port to): it stands alone, and its seeded Bonito
init is the one the port reads and the CLI draws; and the model's yaml
through the basecall CLI's ``--sig-config``.  ``torch`` and the port are
imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import numpy as np

from tests.torch_lstm_tiny import config
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "benchmark" / "core" / "reference_lstm_crf.py"


def test_reference_stands_alone_and_draws_bonito_init():
    """The reference imports torch, numpy and the transformer-CRF
    reference alone (no JAX, nothing of either package) and the
    benchmark's sources keep their rules; its ``bonito_lstm_init`` has
    Bonito's init (orthogonal gate blocks, ``bias_ih`` 0.5 times a
    normal truncated to ±2, ``bias_hh`` zero, uniform ``±1/sqrt(fan_in)``
    elsewhere), loads into the port's model under its names, and equals
    the port's own ``init_lstm_crf`` (the CLI's ``--seed``) for a
    seed."""
    import torch

    from benchmark.core import isolation
    from benchmark.core import reference_lstm_crf as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.init import init_lstm_crf
    from radian_tpu_torch.models.sig2seq import build_model

    names = isolation.imported_names(REFERENCE)
    assert names <= {"__future__", "math", "numpy", "torch",
                     "torch.nn.functional", "benchmark.core"}, names
    assert isolation.source_faults(REPO / "benchmark") == []
    cfg = config()
    w = ref.bonito_lstm_init(cfg["model"], 2)
    h = cfg["model"]["lstm"]["size"]
    for i in ref.lstm_layers(cfg["model"]):
        pre = f"encoder.{i}.rnn"
        for leaf in ("weight_ih_l0", "weight_hh_l0"):
            for g in np.split(w[f"{pre}.{leaf}"].astype(np.float64), 4):
                assert np.allclose(g @ g.T, np.eye(h), atol=1e-5)
        b = w[f"{pre}.bias_ih_l0"]
        assert np.abs(b).max() <= 1.0 and abs(float(b.std()) - 0.44) < 0.15
        assert not w[f"{pre}.bias_hh_l0"].any()
    for name, fan_in in (("encoder.2.conv.weight", 4 * 19),
                         ("encoder.2.conv.bias", 4 * 19),
                         ("encoder.7.linear.weight", h),
                         ("encoder.7.linear.bias", h)):
        bound = 1 / np.sqrt(fan_in)
        assert np.abs(w[name]).max() <= bound < 1.2 * np.abs(w[name]).max()
    port = build_model(DotDict(cfg))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    mine = init_lstm_crf(DotDict(cfg["model"]), 2)
    assert list(mine) == list(w)
    assert all(np.array_equal(mine[k], w[k]) for k in w)
    other = ref.bonito_lstm_init(cfg["model"], 3)
    assert not np.array_equal(other["encoder.4.rnn.weight_hh_l0"],
                              w["encoder.4.rnn.weight_hh_l0"])
    # a configuration's init_gains scale the same draws, and only the
    # weights they name
    gains = {"conv_weight": 3.0, "lstm_weight_ih": 2.0,
             "crf_head_weight": 1.5}
    scaled = ref.bonito_lstm_init(cfg["model"], 2, gains)
    for k in w:
        g = (3.0 if k.endswith(".conv.weight") else
             2.0 if k.endswith(".rnn.weight_ih_l0") else
             1.5 if k == "encoder.7.linear.weight" else 1.0)
        assert np.array_equal(scaled[k], w[k] * np.float32(g)), k


def test_cli_basecalls_an_lstm_yaml(tmp_path):
    """``--sig-config`` with a ``bonito_lstm_crf`` yaml and
    ``--chunk-batch``: the fasta holds the Basecaller's strings for the
    seeded weights (a read of MAD 0 skipped)."""
    import h5py
    import torch
    import yaml

    from radian_tpu_torch.cli.basecall import main
    from radian_tpu_torch.io.fasta import read_fasta
    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller

    rng = np.random.default_rng(6)
    sigs = [(rng.normal(0, 30, size=n) + 400).astype(np.int16)
            for n in (11000, 4000, 700)]
    sigs[2][:] = 400
    f5 = tmp_path / "f5"
    f5.mkdir()
    with h5py.File(f5 / "reads.fast5", "w") as f:
        for i, sig in enumerate(sigs):
            raw = f.create_group(f"read_r{i}/Raw")
            raw.attrs["read_id"] = f"r{i}"
            raw.create_dataset("Signal", data=sig)
    (tmp_path / "lstm.yaml").write_text(yaml.safe_dump(config()))
    main([str(f5), str(tmp_path / "out"), "--device", "cpu",
          "--sig-config", str(tmp_path / "lstm.yaml"), "--chunk-batch", "2",
          "--seed", "4"])
    got = dict(read_fasta(tmp_path / "out" / "reads-0.fasta"))
    bc = load_basecaller(config_path=tmp_path / "lstm.yaml", seed=4,
                         options=BasecallOptions(chunk_batch=2),
                         compute_dtype=torch.float32, device="cpu")
    assert bc.path.kind == "bonito_lstm_crf"
    want = bc.basecall_signals(sigs)
    assert want[2] is None and set(got) == {"r0", "r1"}
    assert got == {"r0": want[0], "r1": want[1]}
