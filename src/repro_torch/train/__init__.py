"""Training (port of ``repro/train``): ``optimizer.py`` (AdamW),
``train_step.py`` (CE + MoE aux, microbatches, int8 error-feedback
data parallelism) and ``checkpoint.py``."""
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         warmup_cosine)
