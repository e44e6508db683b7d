"""PyTorch / CUDA port of ``dvdx_tpu`` for one NVIDIA H100.

Runs the zeroscope text-to-video main path with Proof-of-Inference recording
on hand-written Hopper kernels (``csrc/``). The package imports neither JAX
nor ``dvdx_tpu``: it keeps its own copies of what it needs. Entry points take
a ``device`` argument that defaults to ``"cuda"``; the CPU runs only when a
caller asks for it, and there every kernel wrapper takes its plain PyTorch
version.
"""

import os

# cuBLAS picks a deterministic workspace only when this is set before CUDA is
# initialised; a re-executed PoI step must reproduce its leaves bit for bit.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def enable_determinism() -> None:
    """Deterministic cuDNN / cuBLAS algorithm choice for re-executable steps
    (no atomics, no autotuned algorithm swaps between runs), and float32
    convolutions and products in float32, not TF32: a float32 model then
    computes on the card what it computes on the CPU, to float32 rounding,
    which the validator's cross-platform tolerance is set for."""
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
