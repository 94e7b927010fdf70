"""The plain reference of the benchmark: float32 PyTorch with TF32 off,
written from the published models and the recipe, importing nothing of the
program under test and nothing of JAX. Its modules carry the reference
models' torch ``state_dict`` names, which the program keeps, so one seeded
state dict loads into both."""

import torch


def plain_precision() -> None:
    """Float32 everywhere: no TF32 in cuDNN convolutions or in matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
