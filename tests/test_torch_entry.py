"""The port's entry points default to the card and refuse what it has
not ported.  ``torch`` and the port are imported inside the test (see
``tests/torch_one_cpu.py``).
"""

import pytest

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def test_entry_points_default_to_the_card_and_refuse_unported(tmp_path):
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
    for opts in (dict(assembly_mode="mean"), dict(prep_mode="strips"),
                 dict(prep_mode="windows"), dict(beam_width=17),
                 dict(decode_type="chunk", beam_width=17),
                 dict(decode_type="chunk", consensus="device")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe.Basecaller(params, options=tpipe.BasecallOptions(**opts),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*device consensus"):
        main(["in_dir", "out_dir", "--decode-type", "chunk", "--consensus",
              "device", "--device", "cpu"])
    # chunk mode and streaming are ported: these construct and run
    bc = tpipe.Basecaller(params, options=tpipe.BasecallOptions(
        decode_type="chunk"), device="cpu")
    assert bc.use_chunk_fused and not bc.chunk_tiled
    assert bc.basecall_directory("in_dir", tmp_path, reads=[],
                                 streaming=True) == 0
    assert (tmp_path / "reads-0.fasta").read_text() == ""
