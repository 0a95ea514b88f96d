"""radian-tpu-torch: the PyTorch/CUDA port of radian_tpu, for an NVIDIA H100.

A second package beside the JAX reference ``radian_tpu``, module for
module.  Ported so far, end to end from fast5 to fasta, in batches or
streaming: MAD normalisation, the causal TCN sig2seq model (float32 or
bfloat16), and CTC prefix beam search, with or without the k-mer LM
fused in, as hand-written CUDA kernels (``csrc/*.cu``, built with
``nvcc`` at first use), in

- global mode, one decode over each whole read: the full-read forward
  with "first" assembly by default; ``prep_mode`` 'strips' (each
  window's kept rows with their context) or 'windows' (every window,
  assembled by ``assembly_mode`` 'first' or 'mean'), which also serves
  any window/step geometry; and
- chunk mode (``decode_type='chunk'``): every overlapped window decoded
  on its own, then stitched on the host by the reference's consensus
  (``csrc/seqmatch.cc``, built with ``g++``) -- ``chunk_prep`` 'fused'
  (default), 'windows', or 'fullprobs' with the tiled centre crop
  (stitched by concatenation) and ``chunk_lm`` (the LM fused into that
  decode); ``consensus='device'`` stitches by offset correlation on the
  card instead (``ops/consensus_device.py``).

Weights come from a flax-layout ``.npz``, the reference's Keras ``.h5``
(``models/keras_import.py``, needs ``h5py``), or a seed: the JAX
package's ``init_params`` for that seed, rebuilt in numpy
(``models/init.py``).

Training (``python -m radian_tpu_torch.cli.train -s SHARDS --device
cuda``): the JAX ``Trainer`` from TFRecord shards, with the CTC loss
(``F.ctc_loss``), optax's update rules written out in torch,
checkpoints that keep the optimizer state, and ``--export-npz`` for
weights ``load_basecaller`` reads; data-parallel over a
``torch.distributed`` group, one process per GPU.

Multi-GPU inference: ``Basecaller(mesh=parallel.make_mesh(...))`` (the
CLI's ``--mesh-data N``) splits each batch over a replica a device in
one process; ``--shard-reads`` basecalls a process's round-robin share.
Also ported: the read-identity evaluation (``eval``), the profiler and
dataset utilities and plots (``utils``), and the JAX package's OpenMP
host decoder (``ops/beam_native.py``, ``csrc/beamsearch.cc``).

It imports ``torch`` and never ``jax`` or ``radian_tpu``.

Subpackages
-----------
- ``radian_tpu_torch.ops``     preprocessing, windows and strips, matrix
                               assembly, beam search (plain, CUDA, host
                               C++), the chunk consensus (host C++ and
                               device), the CTC loss, greedy decode
- ``radian_tpu_torch.models``  the sig2seq TCN network, the flax weight
                               bridge, Keras .h5 import, the seeded init
- ``radian_tpu_torch.lm``      the k-mer LM tables (dense and packed)
- ``radian_tpu_torch.train``   the CTC trainer, the optimizers, the
                               shard dataset
- ``radian_tpu_torch.io``      host I/O: fast5, fasta, TFRecord shards
                               (``csrc/tfrecord.cc``, built with ``g++``)
- ``radian_tpu_torch.utils``   synthetic reads and training windows,
                               the TensorBoard event writer, the
                               profiler, dataset inspection, plots
- ``radian_tpu_torch.parallel`` device meshes, process groups, read
                               sharding
- ``radian_tpu_torch.eval``    read identity (alignment, SAM)
- ``radian_tpu_torch.cli``     basecall and train command lines
"""

__version__ = "0.1.0"


def load_basecaller(*args, **kwargs):
    """Convenience re-export of :func:`radian_tpu_torch.pipeline.load_basecaller`."""
    from radian_tpu_torch.pipeline import load_basecaller as _lb

    return _lb(*args, **kwargs)
