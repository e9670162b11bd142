from .adamw import AdamW, AdamWState, global_norm
from .compress import compress_grads, dequantize_int8, init_residual, quantize_int8
from .schedules import constant, warmup_cosine

__all__ = ["AdamW", "AdamWState", "global_norm", "warmup_cosine", "constant",
           "quantize_int8", "dequantize_int8", "compress_grads", "init_residual"]
