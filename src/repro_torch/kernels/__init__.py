"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), resolved via TACC.

flash_attention -- online-softmax attention forward (causal/bidir/window,
                   k_len, GQA); replaces the Pallas ``_flash_kernel``

Each kernel has its plain-torch version beside it (``ref.py``), which the
wrapper runs for CPU tensors; ``ops.py`` holds the model-layout wrappers and
the TACC registrations.  Sources are built by ``_build.py`` at first use.
"""
from repro_torch.kernels import ops  # noqa: F401  (registers TACC entries)
