"""PyTorch/CUDA port of the DAnA system (``repro``) for NVIDIA Hopper.

The package mirrors ``repro``'s layout and is held against it module by
module. It imports ``torch`` and ``numpy`` only. Entry points run on the
card (``device=None`` means ``"cuda"``) and raise when there is none; callers
ask for the CPU with ``device="cpu"``, where every kernel wrapper takes its
plain PyTorch version.

f32 stays f32: TF32 is switched off for matrix products and convolutions.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
