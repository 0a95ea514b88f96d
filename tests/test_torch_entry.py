"""The port's entry points default to the card and refuse what it has
no reference for (beams over 16).  ``torch`` and the port are imported inside the test (see
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
    # what stays refused: beams over 16 (the reference's int8
    # backpointers overflow)
    for opts in (dict(beam_width=17), dict(decode_type="chunk",
                                           beam_width=17)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe.Basecaller(params, options=tpipe.BasecallOptions(**opts),
                             device="cpu")
    from radian_tpu_torch.parallel import make_mesh

    # a mesh 'model' axis is accepted: the model row's first device runs
    bc = tpipe.Basecaller(params, device="cpu", mesh=make_mesh(
        data=1, model=2, devices=["cpu", "cpu"]))
    assert len(bc._replicas) == 1
    # multi-GPU inference is ported: a mesh constructs, and the CLI's
    # --mesh-data and --shard-reads run (on an empty directory here)
    bc = tpipe.Basecaller(params, device="cpu", mesh=make_mesh(
        data=2, devices=["cpu", "cpu"]))
    assert len(bc._replicas) == 2
    for flag in (["--mesh-data", "2"], ["--shard-reads"]):
        main([str(tmp_path), str(tmp_path / flag[0][2:]), "--device", "cpu",
              *flag])
    assert (tmp_path / "mesh-data" / "reads-0.fasta").read_text() == ""
    assert (tmp_path / "shard-reads" / "reads-h0-0.fasta").read_text() == ""
    # the global strips/windows/'mean' paths, the fallback geometry and
    # the device consensus are ported: these construct
    for opts, fast in ((dict(assembly_mode="mean"), None),
                       (dict(prep_mode="strips"), "strips"),
                       (dict(prep_mode="windows"), None),
                       (dict(step_size=96), None), ({}, "fullread")):
        bc = tpipe.Basecaller(params, options=tpipe.BasecallOptions(**opts),
                              device="cpu")
        assert (bc.path.use_strips, bc.path.use_fullread) == (
            fast == "strips", fast == "fullread")
    with pytest.raises(ValueError, match="requires global decode"):
        tpipe.Basecaller(params, options=tpipe.BasecallOptions(
            prep_mode="fullread", step_size=96), device="cpu")
    # chunk mode and streaming are ported: these construct and run
    bc = tpipe.Basecaller(params, options=tpipe.BasecallOptions(
        decode_type="chunk", consensus="device"), device="cpu")
    assert bc.path.use_chunk_fused and not bc.path.chunk_tiled
    assert bc.basecall_directory("in_dir", tmp_path, reads=[],
                                 streaming=True) == 0
    assert (tmp_path / "reads-0.fasta").read_text() == ""
