"""Training CLI (counterpart of radian_tpu/cli/train.py).

The JAX CLI's flags, same names and defaults (reference train.py:100-114
plus the JAX package's), and ``--device`` and ``--export-npz``.

Usage:
    python -m radian_tpu_torch.cli.train -s SHARDS_DIR --device cuda \
        [-g CONFIG] [-c CHECKPOINT_DIR [-e EPOCH]] [--steps-per-epoch N] \
        [--n-epochs N] [--compute-dtype bfloat16] [--epoch-scan] \
        [--eval-edit-distance] [--export-npz params.npz]

``SHARDS_DIR`` holds ``train/*.tfrecords`` and ``val/*.tfrecords``.
Training shards repeat forever, so give ``--steps-per-epoch``.

Data-parallel training runs one process per GPU: start each with
``--num-processes N --process-id I --coordinator HOST:PORT`` (or a
``file://`` URL), or under ``torchrun --nproc-per-node N`` with no
flags; ``--device cpu`` trains over gloo on the CPU.  Each process reads
its share of the train shards (``host_shard_files``) with data seed
``seed + rank``; rank 0 writes the checkpoints, logs and export.

``--mesh-model M`` splits the model over M devices of each process
(tensor parallelism, ``models/tensor_parallel.py``): the process with
local rank ``r`` takes ``cuda:(r·M + j) mod device count`` for ``j <
M`` (``parallel.model_row_devices``), ``--device cpu`` M CPU devices.
The data seed and the train files stay per process: one process is one
data index.  Checkpoints and ``--export-npz`` hold the full leaves.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--checkpoint",
                   help="checkpoint directory to resume from")
    p.add_argument("-e", "--initial_epoch", type=int, default=None,
                   help="epoch to resume training at (inferred from the "
                        "checkpoint if omitted)")
    p.add_argument("-g", "--config-file",
                   help="yaml config (defaults to the bundled sig2seq "
                        "config)")
    p.add_argument("-s", "--shards-dir", required=True,
                   help="directory containing train/val shard files")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--n-epochs", type=int, default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=1,
                   help="devices each process splits the model over "
                        "(tensor parallelism)")
    p.add_argument("--max-label", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16 runs conv/dense math in bfloat16 "
                        "(params/optimizer/loss stay f32)")
    p.add_argument("--epoch-scan", action="store_true",
                   help="upload the batch pool to the device once and "
                        "index it there each step (the pool must fit "
                        "device memory)")
    p.add_argument("--eval-edit-distance", action="store_true",
                   help="greedy-decode edit distance on the val set at "
                        "each val epoch (the reference's "
                        "EditDistanceCallback, working)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--export-npz", default=None,
                   help="write the trained weights here as a flax-layout "
                        ".npz, which load_basecaller (and the JAX "
                        "package's load_params_npz) reads")
    return p


def main(argv=None):
    """Train; returns the :class:`~radian_tpu_torch.train.trainer.Trainer`
    (closed), for callers that drive the CLI from Python.  A process group
    this call forms is destroyed before it returns."""
    args = build_parser().parse_args(argv)

    import torch.distributed as dist

    from radian_tpu_torch.parallel.distributed import initialize

    had_group = dist.is_initialized()
    initialize(args.coordinator, args.num_processes, args.process_id,
               device=args.device)
    try:
        return _train(args)
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args):
    from radian_tpu_torch.config import default_config, get_config
    from radian_tpu_torch.models.checkpoint import save_params_npz
    from radian_tpu_torch.parallel.distributed import rank, world_size
    from radian_tpu_torch.train.data import (
        ShardDataset,
        host_shard_files,
        list_shards,
    )
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    config = (
        get_config(args.config_file) if args.config_file else default_config()
    )
    window = config.data.window_size
    batch = config.train.batch_size

    train_files = host_shard_files(list_shards(args.shards_dir, "train"),
                                   rank(), world_size())
    val_files = list_shards(args.shards_dir, "val")

    tcfg = TrainConfig(
        steps_per_epoch=args.steps_per_epoch,
        checkpoint_dir=args.checkpoint or args.checkpoint_dir,
        log_dir=args.log_dir,
        seed=args.seed,
        mesh_data=args.mesh_data,
        mesh_model=args.mesh_model,
        compute_dtype=args.compute_dtype,
        device=args.device,
    )
    trainer = Trainer(config, tcfg)

    initial_epoch = 0
    if args.checkpoint:
        initial_epoch = trainer.restore_checkpoint(args.initial_epoch)
        print(f"resuming at epoch {initial_epoch}")

    def train_factory():
        return ShardDataset(
            train_files, batch, train=True, window=window,
            max_label=args.max_label, seed=args.seed + rank(),
        )

    def val_factory():
        return ShardDataset(
            val_files, batch, train=False, window=window,
            max_label=args.max_label,
        )

    try:
        history = trainer.fit(
            train_factory,
            val_factory if val_files else None,
            n_epochs=args.n_epochs,
            initial_epoch=initial_epoch,
            epoch_scan=args.epoch_scan,
            eval_edit_distance=args.eval_edit_distance,
        )
    finally:
        trainer.close()
    if args.export_npz and trainer.rank == 0:
        save_params_npz(trainer.model, args.export_npz)
    print(f"final train loss: {history['train_loss'][-1]:.4f}")
    if history["val_loss"]:
        print(f"final val loss: {history['val_loss'][-1]:.4f}")
    return trainer


if __name__ == "__main__":
    main()
