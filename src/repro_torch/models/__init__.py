"""The model stack in PyTorch: layers and the decoder built from them
(attention, MoE, Mamba and RG-LRU layer kinds), and its training loss."""
