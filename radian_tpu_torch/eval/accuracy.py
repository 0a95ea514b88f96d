"""SAM-based read-identity accuracy (minimap2 output; the port's copy of
radian_tpu/eval/accuracy.py, numpy only).

Reimplements the reference's pysam-based eval (reference
radian/accuracy.py) with a minimal text SAM parser: skip
unmapped/secondary/reverse/supplementary records, keep only
protein-coding transcripts, count CIGAR M/I/D, derive substitutions from
the NM tag (``n_sub = NM − ins − del``, matches subtracted;
reference accuracy.py:55-67), identity = match/(match+NM).
"""

from __future__ import annotations

import re

import numpy as np

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


def parse_sam_records(path):
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            tags = {}
            for t in fields[11:]:
                parts = t.split(":", 2)
                if len(parts) == 3:
                    tags[parts[0]] = (
                        int(parts[2]) if parts[1] == "i" else parts[2]
                    )
            yield {
                "qname": fields[0],
                "flag": int(fields[1]),
                "rname": fields[2],
                "cigar": fields[5],
                "seq": fields[9],
                "tags": tags,
            }


def sam_accuracy(sam_path, out_tsv_path=None,
                 protein_coding_only: bool = True) -> dict:
    stats = []
    counters = {"unmapped": 0, "secondary": 0, "reverse": 0,
                "supplementary": 0}
    out = open(out_tsv_path, "w") if out_tsv_path else None
    if out:
        out.write("read_id\tref_name\tn_match\tn_ins\tn_del\tn_sub\n")
    for rec in parse_sam_records(sam_path):
        flag = rec["flag"]
        if flag & FLAG_UNMAPPED:
            counters["unmapped"] += 1
            continue
        if flag & FLAG_SECONDARY:
            counters["secondary"] += 1
            continue
        if flag & FLAG_REVERSE:
            counters["reverse"] += 1
            continue
        if flag & FLAG_SUPPLEMENTARY:
            counters["supplementary"] += 1
            continue
        if not rec["seq"] or rec["seq"] == "*":
            continue

        ref_name = rec["rname"].split("|")
        transcript = ref_name[0]
        if protein_coding_only and (
            len(ref_name) <= 7 or ref_name[7] != "protein_coding"
        ):
            continue

        n_match = n_ins = n_del = 0
        for count, op in _CIGAR_RE.findall(rec["cigar"]):
            c = int(count)
            if op == "M":
                n_match += c
            elif op == "I":
                n_ins += c
            elif op == "D":
                n_del += c
        nm = rec["tags"].get("NM", 0)
        n_sub = nm - n_ins - n_del
        n_match -= n_sub
        if out:
            out.write(
                f"{rec['qname']}\t{transcript}\t{n_match}\t{n_ins}\t"
                f"{n_del}\t{n_sub}\n"
            )
        denom = max(n_match + nm, 1)
        stats.append([
            100.0 * n_match / denom,
            100.0 * n_ins / denom,
            100.0 * n_del / denom,
            100.0 * n_sub / denom,
            100.0 * (n_ins + n_del + n_sub) / denom,
        ])
    if out:
        out.close()
    if not stats:
        return {"n_reads": 0, **counters}
    arr = np.asarray(stats)
    keys = ("accuracy", "p_ins", "p_del", "p_sub", "p_err")
    summary = {
        k: {"median": float(np.median(arr[:, i])),
            "mean": float(np.mean(arr[:, i]))}
        for i, k in enumerate(keys)
    }
    summary["n_reads"] = len(stats)
    summary.update(counters)
    return summary


def main(argv=None):
    """CLI: ``python -m radian_tpu_torch.eval.accuracy ALN_SAM [OUT_TSV]`` —
    prints the reference-format summary (reference accuracy.py:81-91)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="SAM alignment accuracy (reference accuracy.py)")
    ap.add_argument("sam")
    ap.add_argument("out_tsv", nargs="?", default=None)
    a = ap.parse_args(argv)
    sam = a.sam
    out = a.out_tsv or sam.replace(".sam", "-pc.tsv")
    s = sam_accuracy(sam, out)
    print(f"N unmapped reads: {s.get('unmapped', 0)}")
    print(f"N reverse strand reads: {s.get('reverse', 0)}")
    print(f"N secondary reads: {s.get('secondary', 0)}")
    print(f"N supplementary reads: {s.get('supplementary', 0)}")
    print(f"N mapped reads: {s.get('n_reads', 0)}")
    for label, key in (
        ("Accuracy", "accuracy"), ("Insertions", "p_ins"),
        ("Deletions", "p_del"), ("Substitutions", "p_sub"),
        ("Total error", "p_err"),
    ):
        if key in s:
            print(f"{label}\tMEDIAN: {s[key]['median']:.2f}\t"
                  f"MEAN: {s[key]['mean']:.2f}")


if __name__ == "__main__":
    main()
