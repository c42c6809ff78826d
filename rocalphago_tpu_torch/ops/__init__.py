"""Hand-written CUDA kernels with their plain PyTorch versions:
:mod:`.labels` (group labelling), :mod:`.chase` (the ladder read),
:mod:`.tree` (the device search's tree walks) and :mod:`.conv_epilogue`
(the trunk convolutions' bias and ReLU, and their backward).
"""
