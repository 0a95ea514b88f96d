"""The transformer-CRF model's plain reference
(``benchmark/core/reference_tx_crf.py``, which the benchmark, the port's
tests and ``chip_smoke.py`` hold the port to): it stands alone, and its
seeded Bonito init is the one the port reads and the CLI draws; and the
model's yaml through the basecall CLI's ``--sig-config``.  ``torch``
and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import math
from pathlib import Path

import numpy as np

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)
from tests.torch_tx_tiny import config

REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "benchmark" / "core" / "reference_tx_crf.py"


def test_reference_stands_alone_and_draws_bonito_init():
    """The reference imports torch and numpy alone (no JAX, nothing of
    either package) and the benchmark's sources keep their rules; its
    ``bonito_init`` has Bonito's gains (Xavier-normal, the DeepNorm β on
    ``fc1``, ``fc2``, ``out_proj`` and Wqkv's V rows, 1 on its Q and K
    rows; uniform ``±1/sqrt(fan_in)`` elsewhere; RMSNorm ones), loads
    into the port's model under its names and shapes, and equals the
    port's own ``init_tx_crf`` (the CLI's ``--seed``) for a seed."""
    import json

    import torch

    from benchmark.core import isolation
    from benchmark.core import reference_tx_crf as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.init import init_tx_crf
    from radian_tpu_torch.models.sig2seq import build_model

    names = {n.split(".")[0] for n in isolation.imported_names(REFERENCE)}
    assert names <= {"__future__", "math", "numpy", "torch"}, names
    assert isolation.source_faults(REPO / "benchmark") == []
    # the published widths, where the gains' spread is well measured
    model = json.loads((REPO / "benchmark" / "configs"
                        / "bonito-tx-sup-v5-bf16.json").read_text())[
        "model_config"]["model"]
    w = ref.bonito_init(model, 3)
    d, ff = 512, 2048
    beta = model["encoder"]["deepnorm_beta"]
    qkv = w["encoder.7.self_attn.Wqkv.weight"]
    for x, want in ((qkv[:2 * d], math.sqrt(2 / (3 * d))),
                    (qkv[2 * d:], beta * math.sqrt(2 / (2 * d))),
                    (w["encoder.7.self_attn.out_proj.weight"],
                     beta * math.sqrt(2 / (2 * d))),
                    (w["encoder.7.ff.fc1.weight"],
                     beta * math.sqrt(2 / (2 * ff + d))),
                    (w["encoder.7.ff.fc2.weight"],
                     beta * math.sqrt(2 / (ff + d)))):
        assert abs(float(x.std()) / want - 1) < 0.01, (x.shape, want)
    for name, fan_in in (("stem.2.weight", 64 * 9), ("stem.2.bias", 64 * 9),
                         ("upsample.weight", d), ("crf.weight", d)):
        bound = 1 / math.sqrt(fan_in)
        assert np.abs(w[name]).max() <= bound < 1.1 * np.abs(w[name]).max()
    assert np.array_equal(w["encoder.0.norm2.weight"], np.ones(d, np.float32))
    # the port's model takes the reference's names and shapes (the narrow
    # config), and its own seeded init draws the same weights
    cfg = config()
    w = ref.bonito_init(cfg["model"], 2)
    port = build_model(DotDict(cfg))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    mine = init_tx_crf(DotDict(cfg["model"]), 2)
    assert list(mine) == list(w)
    assert all(np.array_equal(mine[k], w[k]) for k in w)


def test_cli_basecalls_a_tx_yaml(tmp_path):
    """``--sig-config`` with a ``bonito_tx_crf`` yaml and
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
            for n in (13000, 5000, 700)]
    sigs[2][:] = 400
    f5 = tmp_path / "f5"
    f5.mkdir()
    with h5py.File(f5 / "reads.fast5", "w") as f:
        for i, sig in enumerate(sigs):
            raw = f.create_group(f"read_r{i}/Raw")
            raw.attrs["read_id"] = f"r{i}"
            raw.create_dataset("Signal", data=sig)
    (tmp_path / "tx.yaml").write_text(yaml.safe_dump(config()))
    main([str(f5), str(tmp_path / "out"), "--device", "cpu",
          "--sig-config", str(tmp_path / "tx.yaml"), "--chunk-batch", "2",
          "--seed", "4"])
    got = dict(read_fasta(tmp_path / "out" / "reads-0.fasta"))
    bc = load_basecaller(config_path=tmp_path / "tx.yaml", seed=4,
                         options=BasecallOptions(chunk_batch=2),
                         compute_dtype=torch.float32, device="cpu")
    want = bc.basecall_signals(sigs)
    assert want[2] is None and set(got) == {"r0", "r1"}
    assert got == {"r0": want[0], "r1": want[1]}
