"""Basecall CLI (counterpart of radian_tpu/cli/basecall.py).

The JAX CLI's flags, same names and defaults, plus ``--device``.
``--mesh-data N`` shards each read batch over the first N GPUs in this
process (with ``--device cpu``: N replicas on the CPU); ``--shard-reads``
basecalls this process's round-robin share of the reads into
``reads-h<rank>-*.fasta`` (``parallel/distributed.py``; the rank and
world size are the process group's, or torchrun's variables).

Usage:
    python -m radian_tpu_torch.cli.basecall FAST5_DIR FASTA_DIR --device cuda \
        [--rna-model LM.json] [--compute-dtype bfloat16] \
        [--sig-model params.npz|model.h5] [--prep-mode strips|windows] \
        [--assembly-mode mean] \
        [--decode-type chunk [--chunk-prep fullprobs [--chunk-lm]] \
         [--consensus device]] [--streaming] [--mesh-data N] \
        [--shard-reads]

A Bonito CRF model, ``bonito_tx_crf`` (the transformer-CRF basecaller)
or ``bonito_lstm_crf`` (the LSTM-CRF basecaller), runs through the same
command, its yaml given to ``--sig-config`` (weights from
``--sig-model`` as an ``.npz`` of its state dict, else seeded):

    python -m radian_tpu_torch.cli.basecall FAST5_DIR FASTA_DIR \
        --sig-config tx_sup_v5.yaml --compute-dtype bfloat16 \
        --chunk-batch 512
    python -m radian_tpu_torch.cli.basecall FAST5_DIR FASTA_DIR \
        --sig-config lstm_sup_v4.yaml --compute-dtype bfloat16 \
        --chunk-batch 512
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Basecall a nanopore dRNA sequencing run on a GPU."
    )
    p.add_argument("fast5_dir", help="Directory of single/multi fast5 files.")
    p.add_argument("fasta_dir", help="Directory to output fasta files.")
    p.add_argument("--local", action="store_true",
                   help="(reference compat; no effect)")
    p.add_argument("--chunk-len", default=1024, type=int)
    p.add_argument("--step-size", default=128, type=int)
    p.add_argument("--batch-size", default=32, type=int,
                   help="(accepted for reference compat; superseded by "
                        "--read-batch bucketing)")
    p.add_argument("--outlier-clip", default=4, type=float)
    p.add_argument("--rna-model", default="None",
                   help="k-mer LM json path (the reference's format, "
                        "contexts of --context-len bases), or 'None' to "
                        "decode without LM fusion")
    p.add_argument("--sig-model", default=None,
                   help="checkpoint: flax-layout .npz, the reference's "
                        "Keras .h5 (needs h5py), or omit for seeded init "
                        "(the JAX package's weights for --seed)")
    p.add_argument("--sig-config", default=None,
                   help="model config yaml: radian's sig2seq schema, or a "
                        "Bonito CRF model (model.type: bonito_tx_crf or "
                        "bonito_lstm_crf, with a basecaller section: "
                        "chunksize, overlap)")
    p.add_argument("--beam-width", default=6, type=int)
    p.add_argument("--decode-type", choices=["global", "chunk"],
                   default="global")
    p.add_argument("--sig-threshold", default=0.5, type=float)
    p.add_argument("--rna-threshold", default=0.5, type=float)
    p.add_argument("--context-len", default=11, type=int)
    p.add_argument("--read-batch", default=8, type=int,
                   help="reads decoded concurrently per bucket")
    p.add_argument("--assembly-mode", choices=["first", "mean"],
                   default="first")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="forward dtype; bfloat16 also stores the LM tables "
                        "in bfloat16")
    p.add_argument("--prep-mode",
                   choices=["auto", "fullread", "strips", "windows"],
                   default="auto",
                   help="global-mode forward: 'fullread' = one causal TCN "
                        "pass over the whole read; 'strips' = each "
                        "window's kept rows with their context; 'windows' "
                        "= every window, then assembly (any geometry, "
                        "needed for --assembly-mode mean); 'auto' = "
                        "fullread where valid, else windows")
    p.add_argument("--chunk-prep",
                   choices=["auto", "fused", "fullprobs", "windows"],
                   default="auto",
                   help="chunk-mode path: 'fused' (auto) = full-read "
                        "forward + zero-history window heads; 'windows' = "
                        "forward over every window; 'fullprobs' = windows "
                        "cut from the full-read forward (corrected, not "
                        "the reference's strings)")
    p.add_argument("--no-chunk-crop", action="store_true",
                   help="'fullprobs' without the tiled centre crop: "
                        "stitch overlapping fragments by consensus")
    p.add_argument("--chunk-lm", action="store_true",
                   help="fuse the k-mer LM into the tiled chunk decode "
                        "(needs --rna-model, --chunk-prep fullprobs and "
                        "the crop)")
    p.add_argument("--chunk-max-lab", default=512, type=int,
                   help="per-window emission cap of the fused chunk "
                        "paths' label compaction (overflow raises)")
    p.add_argument("--consensus", choices=["reference", "device"],
                   default="reference",
                   help="chunk-mode stitch: 'reference' (difflib "
                        "semantics, in C++); 'device' = offset "
                        "correlation (4-run scoring) on the GPU")
    p.add_argument("--seed", default=0, type=int,
                   help="init seed when no --sig-model is given")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="shard each read batch over this many local GPUs "
                        "(single-process multi-GPU; --read-batch must be "
                        "divisible by it)")
    p.add_argument("--shard-reads", action="store_true",
                   help="multi-host: each host basecalls its share of reads")
    p.add_argument("--streaming", action="store_true",
                   help="bounded-memory streaming mode: fasta written in "
                        "read order as batches finish")
    p.add_argument("--bucket-lengths", default=None,
                   help="comma-separated fixed bucket ladder (e.g. "
                        "'4096,8192,16384')")
    p.add_argument("--prewarm", action="store_true",
                   help="run one batch per --bucket-lengths entry before "
                        "processing reads")
    p.add_argument("--chunk-batch", default=64, type=int,
                   help="chunks a batch of a Bonito CRF model")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch "
                        "path")
    return p


def main(argv=None) -> None:
    """Basecall; with ``--shard-reads``, the process group this call
    forms from torchrun's variables is destroyed before it returns."""
    args = build_parser().parse_args(argv)
    if not args.shard_reads:
        return _basecall(args)

    import torch.distributed as dist

    from radian_tpu_torch.parallel.distributed import initialize

    # torchrun's group, if any, before anything lands on a bare 'cuda':
    # it makes cuda:<LOCAL_RANK> this process's device
    had_group = dist.is_initialized()
    initialize(device=args.device)
    try:
        _basecall(args)
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


def _basecall(args) -> None:
    import torch

    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller

    options = BasecallOptions(
        chunk_len=args.chunk_len,
        step_size=args.step_size,
        outlier_clip=args.outlier_clip,
        beam_width=args.beam_width,
        decode_type=args.decode_type,
        sig_threshold=args.sig_threshold,
        rna_threshold=args.rna_threshold,
        context_len=args.context_len,
        assembly_mode=args.assembly_mode,
        read_batch=args.read_batch,
        prep_mode=args.prep_mode,
        chunk_prep=args.chunk_prep,
        chunk_crop=not args.no_chunk_crop,
        chunk_lm=args.chunk_lm,
        chunk_max_lab=args.chunk_max_lab,
        consensus=args.consensus,
        chunk_batch=args.chunk_batch,
        bucket_lengths=(
            tuple(int(x) for x in args.bucket_lengths.split(","))
            if args.bucket_lengths else None
        ),
    )
    mesh = None
    if args.mesh_data is not None:
        from radian_tpu_torch.parallel.mesh import make_mesh

        devices = ([args.device] * args.mesh_data
                   if torch.device(args.device).type == "cpu" else None)
        mesh = make_mesh(data=args.mesh_data, model=1, devices=devices)
    bc = load_basecaller(
        checkpoint=args.sig_model,
        config_path=args.sig_config,
        rna_model=args.rna_model,
        options=options,
        seed=args.seed,
        compute_dtype=(
            torch.bfloat16 if args.compute_dtype == "bfloat16"
            else torch.float32
        ),
        mesh=mesh,
        device=args.device,
    )
    if args.prewarm:
        t = bc.warmup()
        print(f"prewarm: ran {len(set(options.bucket_lengths))} bucket "
              f"batches in {t:.1f}s")
    if args.shard_reads:
        from radian_tpu_torch.parallel.distributed import basecall_sharded

        basecall_sharded(bc, args.fast5_dir, args.fasta_dir)
    else:
        bc.basecall_directory(args.fast5_dir, args.fasta_dir,
                              streaming=args.streaming)


if __name__ == "__main__":
    main()
