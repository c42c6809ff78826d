"""Hand-written CUDA kernels with their plain PyTorch versions:
:mod:`.labels` (group labelling), :mod:`.chase` (the ladder read) and
:mod:`.tree` (the device search's tree walks).
"""
