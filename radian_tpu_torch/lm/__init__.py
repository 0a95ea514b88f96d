"""The 12-mer mRNA language model tables (the port's copy of radian_tpu.lm)."""

from radian_tpu_torch.lm.kmer import (  # noqa: F401
    KmerLM,
    build_dense_tables,
    load_kmer_json,
    pack_context,
    random_kmer_model,
)
