"""The port's entry points default to the card and refuse what this slice
has not ported.  ``torch`` and the port are imported inside the test (see
``tests/torch_one_cpu.py``).
"""

import pytest

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def test_entry_points_default_to_the_card_and_refuse_unported():
    import torch

    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.cli.basecall import main
    from radian_tpu_torch.models.sig2seq import build_model

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.load_basecaller()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["in_dir", "out_dir"])
    params = build_model().state_dict()
    for opts in (dict(decode_type="chunk"), dict(assembly_mode="mean"),
                 dict(prep_mode="strips"), dict(beam_width=17),
                 dict(chunk_lm=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe.Basecaller(params, options=tpipe.BasecallOptions(**opts),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.load_basecaller(device="cpu").basecall_directory(
            "in_dir", "out_dir", streaming=True)
