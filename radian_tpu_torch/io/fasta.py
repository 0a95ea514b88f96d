"""fasta output with per-file read-count rollover.

Matches the reference basecaller's output behavior (reference
radian/basecall.py:64-67,128-141): files named ``reads-<n>.fasta``, at
most ``reads_per_file`` records per file, one ``>read_id\\nsequence``
record per read.  Sequence reversal (3'→5' decode order to 5'→3' output)
is the caller's responsibility, as in the reference.
"""

from __future__ import annotations

from pathlib import Path


class FastaWriter:
    def __init__(self, out_dir: str | Path, reads_per_file: int = 1000,
                 prefix: str = "reads"):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.reads_per_file = reads_per_file
        self.prefix = prefix
        self._file_n = 0
        self._count_in_file = 0
        self._fh = open(self._path(), "w")

    def _path(self) -> Path:
        return self.out_dir / f"{self.prefix}-{self._file_n}.fasta"

    def write(self, read_id: str, sequence: str) -> None:
        self._fh.write(f">{read_id}\n{sequence}\n")
        self._count_in_file += 1
        if self._count_in_file == self.reads_per_file:
            self._fh.close()
            self._file_n += 1
            self._count_in_file = 0
            self._fh = open(self._path(), "w")

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_fasta(path: str | Path) -> dict[str, str]:
    """Parse a fasta file into ``{read_id: sequence}`` (test/eval helper)."""
    out: dict[str, str] = {}
    rid = None
    seq_parts: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if rid is not None:
                    out[rid] = "".join(seq_parts)
                rid = line[1:].split()[0]
                seq_parts = []
            else:
                seq_parts.append(line)
    if rid is not None:
        out[rid] = "".join(seq_parts)
    return out
