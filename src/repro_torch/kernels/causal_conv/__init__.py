"""The Mamba-1 mixer's causal depthwise conv, with its bias and SiLU: the
plain version (``ref``), CUDA kernel wrapper (``kernel``) and the public op
(``ops``)."""

from .ops import MODES, causal_conv
from .ref import causal_conv_ref

__all__ = ["MODES", "causal_conv", "causal_conv_ref"]
