"""The port's read-identity evaluation (``radian_tpu_torch.eval``, its
numpy copy of ``radian_tpu/eval``) gives exactly the JAX package's
results on the same seeded inputs: the Gotoh alignment strings, the
per-read metrics, the fasta summary (with the random-call baseline) and
its TSV, the SAM summary and its TSV, and the two ``main()`` entry
points' output.  The port is imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import numpy as np

from radian_tpu.eval import accuracy as jacc
from radian_tpu.eval import align as jalign
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _mutate(rng, seq: str) -> str:
    """A noisy basecall of ``seq``: ~8 % substitutions, insertions and
    deletions each, and some leading garbage."""
    out = list("".join(rng.choice(list("ACGT"), rng.integers(0, 6))))
    for b in seq:
        r = rng.random()
        if r < 0.08:
            out.append("ACGT"[rng.integers(4)])
        elif r < 0.16:
            out += [b, "ACGT"[rng.integers(4)]]
        elif r >= 0.24:
            out.append(b)
    return "".join(out).replace("T", "U") if rng.random() < 0.5 else \
        "".join(out)


def test_align_and_fasta_summary_equal_jax(tmp_path, capsys):
    from radian_tpu_torch.eval import align as talign
    from radian_tpu_torch.eval import evaluate_fasta, global_align

    rng = np.random.default_rng(7)
    refs = ["".join(rng.choice(list("ACGT"), n))
            for n in rng.integers(1, 300, 24)]
    calls = [_mutate(rng, r) for r in refs]
    for ref, call in zip(refs, calls):
        q = call.replace("U", "T")
        assert global_align(ref, q) == jalign.global_align(ref, q)
        assert talign.read_identity(ref, call) == \
            jalign.read_identity(ref, call)
        assert talign.random_identity_baseline(ref, len(call)) == \
            jalign.random_identity_baseline(ref, len(call))

    fasta = tmp_path / "calls.fasta"
    fasta.write_text("".join(f">r{i}\n{c}\n" for i, c in enumerate(calls)))
    tsv = tmp_path / "refs.tsv"
    tsv.write_text("read\ttxt\tseq\n" + "".join(
        f"r{i}\tt{i}\t{r}\n" for i, r in enumerate(refs[:-2])))
    for baseline in (False, True):
        got = evaluate_fasta(fasta, tsv, tmp_path / "t.tsv",
                             with_baseline=baseline)
        want = jalign.evaluate_fasta(fasta, tsv, tmp_path / "j.tsv",
                                     with_baseline=baseline)
        assert got == want and got["n_reads"] == 22
        assert (tmp_path / "t.tsv").read_text() == \
            (tmp_path / "j.tsv").read_text()
    talign.main([str(fasta), str(tsv), "--baseline"])
    got_out = capsys.readouterr().out
    jalign.main([str(fasta), str(tsv), "--baseline"])
    assert got_out == capsys.readouterr().out
    assert "Random-call baseline" in got_out


def test_sam_accuracy_equals_jax(tmp_path, capsys):
    from radian_tpu_torch.eval import accuracy as tacc
    from radian_tpu_torch.eval import sam_accuracy

    rng = np.random.default_rng(11)
    lines = ["@SQ\tSN:ENST1|g|h|i|j|k|l|protein_coding|x\tLN:1000"]
    flags = (0, 0, 0, 4, 16, 256, 2048, 0)
    for i in range(60):
        m, ins, dele = (int(x) for x in rng.integers(1, 40, 3))
        nm = ins + dele + int(rng.integers(0, m))
        kind = ("protein_coding" if rng.random() < 0.8 else "lncRNA")
        seq = "*" if rng.random() < 0.05 else "A" * (m + ins)
        lines.append("\t".join([
            f"r{i}", str(flags[i % len(flags)]),
            f"ENST{i % 3}|g|h|i|j|k|l|{kind}|x", "1", "60",
            f"{m}M{ins}I{m // 2}M{dele}D{m // 3 + 1}M", "*", "0", "0", seq,
            "*", f"NM:i:{nm}", "AS:i:5"]))
    sam = tmp_path / "aln.sam"
    sam.write_text("\n".join(lines) + "\n")
    for pc in (True, False):
        got = sam_accuracy(sam, tmp_path / "t.tsv", protein_coding_only=pc)
        want = jacc.sam_accuracy(sam, tmp_path / "j.tsv",
                                 protein_coding_only=pc)
        assert got == want and got["n_reads"] > 10
        assert (tmp_path / "t.tsv").read_text() == \
            (tmp_path / "j.tsv").read_text()
    tacc.main([str(sam), str(tmp_path / "t2.tsv")])
    got_out = capsys.readouterr().out
    jacc.main([str(sam), str(tmp_path / "j2.tsv")])
    assert got_out == capsys.readouterr().out
