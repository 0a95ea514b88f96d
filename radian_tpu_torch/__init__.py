"""radian-tpu-torch: the PyTorch/CUDA port of radian_tpu, for an NVIDIA H100.

A second package beside the JAX reference ``radian_tpu``, module for
module.  Ported so far: global-mode basecalling end to end: fast5
ingest, MAD normalisation, the causal TCN sig2seq model (float32 or
bfloat16), global "first" assembly, and CTC prefix beam search, with or
without the k-mer LM fused in, as hand-written CUDA kernels
(``csrc/*.cu``, built with ``nvcc`` at first use).  It imports ``torch``
and never ``jax`` or ``radian_tpu``.

Subpackages
-----------
- ``radian_tpu_torch.ops``     preprocessing, beam search (plain + CUDA)
- ``radian_tpu_torch.models``  the sig2seq TCN network + flax weight bridge
- ``radian_tpu_torch.lm``      the k-mer LM tables (dense and packed)
- ``radian_tpu_torch.io``      host I/O: fast5, fasta
- ``radian_tpu_torch.cli``     basecall command line
"""

__version__ = "0.1.0"


def load_basecaller(*args, **kwargs):
    """Convenience re-export of :func:`radian_tpu_torch.pipeline.load_basecaller`."""
    from radian_tpu_torch.pipeline import load_basecaller as _lb

    return _lb(*args, **kwargs)
