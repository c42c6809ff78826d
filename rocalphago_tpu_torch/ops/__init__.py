"""Hand-written CUDA kernels with their plain PyTorch versions:
:mod:`.labels` (group labelling) and :mod:`.chase` (the ladder read).
"""
