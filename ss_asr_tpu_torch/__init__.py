"""ss_asr_tpu_torch — the PyTorch / CUDA port of ``ss_asr_tpu`` for NVIDIA Hopper.

The JAX package ``ss_asr_tpu`` is the reference; this package mirrors its
layout (``models/las.py`` here is the counterpart of ``models/las.py``
there) and is held against it on the same weights and inputs.  It imports
``torch``, ``numpy`` and the standard library only — never ``jax`` and never
``ss_asr_tpu`` (whose ``__init__`` imports jax whenever ``JAX_PLATFORMS`` is
set), so it runs on a machine that has no JAX.

Ported so far: the whole serving path — the log-mel frontend (batched and
streaming), the pyramidal BiLSTM listener, greedy and beam decoding with
optional char-LM shallow fusion, n-best hypotheses with confidence and
timestamps from a forced-alignment pass, LM rescoring, long-form and
streaming decodes, the ``Transcriber`` API, the dynamic batcher and the
HTTP server with hot reload; the supervised train step with ``ASRTrainer``;
data preparation (``cli.mkdata``, ``cli.preprocess``); and the
semi-supervised trainers (text autoencoder, speech autoencoder, adversarial
listener) with the ``Seed`` chain that runs them (``cli.train``); the
char-LM trainer (``cli.generate``, ``cli.lm_predict``), the test-set
decoder ``ASRTester``, ``cli.pseudolabel``, ``cli.avg_ckpt`` and
``cli.import_ckpt``; and data parallelism (``parallel/``: every trainer over
``torch.distributed`` ranks, mesh serving in ``Transcriber(mesh=)``; tensor
parallelism is left out).  Its hot loops run as CUDA C++ kernels written
for ``sm_90a`` (``csrc/``): the LSTM time loop forward and backward, the
whole greedy decode and the whole beam frontier (each with and without the
LM), the attend-and-spell forward and backward, and the fused log-mel
frontend.

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
