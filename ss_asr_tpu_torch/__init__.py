"""ss_asr_tpu_torch — the PyTorch / CUDA port of ``ss_asr_tpu`` for NVIDIA Hopper.

The JAX package ``ss_asr_tpu`` is the reference; this package mirrors its
layout (``models/las.py`` here is the counterpart of ``models/las.py``
there) and is held against it on the same weights and inputs.  It imports
``torch``, ``numpy`` and the standard library only — never ``jax`` and never
``ss_asr_tpu`` (whose ``__init__`` imports jax whenever ``JAX_PLATFORMS`` is
set), so it runs on a machine that has no JAX.

The slice ported so far is the greedy serving path: the batched log-mel
frontend, the pyramidal BiLSTM listener, greedy attend-and-spell decoding
with optional char-LM shallow fusion, the ``Transcriber`` API, the dynamic
batcher and the HTTP server.  Its three sequential hot loops run as CUDA C++
kernels written for ``sm_90a`` (``csrc/``): the LSTM time loop and the whole
greedy decode, with and without the LM.

Routing is by device alone: a CUDA tensor goes to the kernel, a CPU tensor
to the kernel's plain PyTorch version beside it.  There is no switch.

Precision is full float32 everywhere: TF32 is turned off here, once, for
both matmuls and cuDNN, because the parity tolerances against the JAX
package (which runs these kernels in float32) assume it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
