from radian_tpu_torch.eval.align import (  # noqa: F401
    global_align,
    alignment_stats,
    evaluate_fasta,
)
from radian_tpu_torch.eval.accuracy import sam_accuracy  # noqa: F401
