"""fast5 (HDF5) nanopore read ingestion.

A minimal h5py-based reader replacing the reference's ont-fast5-api
dependency (reference radian/basecall.py:7,70-76: iterate ``*.fast5``
under a directory, yield each read's raw int16 signal).  Supports both
multi-read fast5 (top-level ``read_<uuid>`` groups holding ``Raw/Signal``)
and legacy single-read fast5 (``/Raw/Reads/Read_<n>/Signal``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Fast5Read:
    read_id: str
    signal: np.ndarray  # raw int16 samples
    sampling_rate: float | None = None
    source_file: str | None = None


def _decode(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def iter_fast5_reads(path: str | Path) -> Iterator[Fast5Read]:
    """Yield all reads in one fast5 file (multi- or single-read layout)."""
    import h5py  # only the fast5 reader needs HDF5

    path = str(path)
    with h5py.File(path, "r") as f:
        multi_keys = [k for k in f.keys() if k.startswith("read_")]
        if multi_keys:
            for key in multi_keys:
                grp = f[key]
                raw = grp["Raw"]
                read_id = _decode(raw.attrs.get("read_id", key[len("read_") :]))
                rate = None
                if "channel_id" in grp:
                    rate = float(grp["channel_id"].attrs.get("sampling_rate", 0)) or None
                yield Fast5Read(
                    read_id=read_id,
                    signal=np.asarray(raw["Signal"][()]),
                    sampling_rate=rate,
                    source_file=path,
                )
        elif "Raw" in f and "Reads" in f["Raw"]:
            for rkey in f["Raw"]["Reads"].keys():
                raw = f["Raw"]["Reads"][rkey]
                read_id = _decode(raw.attrs.get("read_id", rkey))
                rate = None
                if "UniqueGlobalKey" in f and "channel_id" in f["UniqueGlobalKey"]:
                    rate = (
                        float(
                            f["UniqueGlobalKey"]["channel_id"].attrs.get(
                                "sampling_rate", 0
                            )
                        )
                        or None
                    )
                yield Fast5Read(
                    read_id=read_id,
                    signal=np.asarray(raw["Signal"][()]),
                    sampling_rate=rate,
                    source_file=path,
                )


def iter_fast5_dir(directory: str | Path) -> Iterator[Fast5Read]:
    """Recursively iterate every read in every ``*.fast5`` under a directory.

    File order matches the reference basecaller's ``Path(...).rglob('*.fast5')``
    traversal (reference basecall.py:70).
    """
    for fp in sorted(Path(directory).rglob("*.fast5")):
        yield from iter_fast5_reads(fp)
