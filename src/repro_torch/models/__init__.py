"""The model stack in PyTorch: layers and the decoder built from them
(attention and MoE layer kinds so far)."""
