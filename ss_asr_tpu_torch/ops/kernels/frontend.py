"""The fused log-mel frontend: CUDA kernel wrapper and its plain version.

Kernel: ``csrc/frontend.cu`` (``ss_fbank``), which replaces the TPU kernel
``ss_asr_tpu/ops/pallas/frontend.py::_fe_kernel`` (``fbank_pallas``): the
frames of an already reflect-padded signal, the windowed DFT product, the
power, the mel product and the log in one launch.  The source's header says
what bounds it on an H100 and how its design answers that.

``fbank`` routes by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor runs ``fbank_plain``, the same function as an ``unfold`` and two
``torch.matmul``s.  Forward only, as the TPU kernel is: features are model
inputs, so a CUDA signal that needs a gradient raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ss_asr_tpu_torch.ops.kernels import build

#: log floor — float64 machine eps, as in the reference's np.finfo(float).eps
LOG_EPS = float(np.finfo(np.float64).eps)

#: kernel launches made by ``fbank`` (one per call on CUDA tensors)
LAUNCHES = {"fbank": 0}


def fbank_plain(yp: torch.Tensor, wbasis: torch.Tensor, mel: torch.Tensor,
                nf: int, n_fft: int, hop: int) -> torch.Tensor:
    """``yp [B, Np]`` padded signals -> ``[B, nf, n_mels]`` log-mels in plain
    PyTorch: frame t of a row is ``yp[t*hop : t*hop + n_fft]``; ``wbasis``
    is the window-fused DFT basis ``[n_fft, 2*n_bins]`` (cos | -sin), ``mel``
    the ``[n_bins, n_mels]`` filterbank."""
    frames = yp.unfold(-1, n_fft, hop)[..., :nf, :]
    spec = torch.matmul(frames, wbasis)
    n_bins = wbasis.shape[1] // 2
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    return torch.log(torch.matmul(power, mel) + LOG_EPS)


#: the kernel's tensor-core tile: K steps of 8 rows, column chunks of 96
K_STEP = 8
COL_CHUNK = 96


def interleave_basis(wbasis: torch.Tensor) -> torch.Tensor:
    """The kernel's layout of the basis: column 2j holds bin j's cos column,
    2j+1 its -sin column (the two adjacent columns of a tensor-core
    accumulator fragment are then re and im of one bin, squared in
    registers), with zero rows up to a multiple of ``K_STEP`` (the depth of
    one ``mma``) and zero columns up to a multiple of ``COL_CHUNK`` (the
    kernel walks the columns in chunks and guards none)."""
    n_fft, two_bins = wbasis.shape
    n_bins = two_bins // 2
    kpad = -(-n_fft // K_STEP) * K_STEP
    ncols = -(-two_bins // COL_CHUNK) * COL_CHUNK
    out = wbasis.new_zeros(kpad, ncols)
    out[:n_fft, 0:two_bins:2] = wbasis[:, :n_bins]
    out[:n_fft, 1:two_bins:2] = wbasis[:, n_bins:]
    return out


def fbank(yp: torch.Tensor, wbasis: torch.Tensor, mel: torch.Tensor, nf: int, n_fft: int,
          hop: int, wbasis_il: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``yp [B, Np]`` float32 reflect-padded signals -> ``[B, nf, n_mels]``
    log-mel filterbanks; Np >= (nf-1)*hop + n_fft.  ``wbasis_il`` is
    ``interleave_basis(wbasis)`` where the caller keeps it (built per call
    otherwise); the CPU route does not read it."""
    B, Np = yp.shape
    n_bins, n_mels = mel.shape
    if wbasis.shape != (n_fft, 2 * n_bins) or (nf > 0 and Np < (nf - 1) * hop + n_fft):
        raise ValueError(f"fbank: yp {tuple(yp.shape)}, wbasis {tuple(wbasis.shape)}, "
                         f"mel {tuple(mel.shape)} do not fit nf={nf}, n_fft={n_fft}, hop={hop}")
    if yp.device.type == "cpu":
        return fbank_plain(yp, wbasis, mel, nf, n_fft, hop)
    if yp.device.type != "cuda":
        raise ValueError(f"fbank: no kernel for device {yp.device}")
    if torch.is_grad_enabled() and yp.requires_grad:
        raise RuntimeError("fbank: the CUDA kernel is forward-only; features are model "
                           "inputs and nothing differentiates through the frontend")
    if wbasis_il is None:
        wbasis_il = interleave_basis(wbasis)
    yp = yp.contiguous()
    for key, t in (("yp", yp), ("wbasis_il", wbasis_il), ("mel", mel)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != yp.device:
            raise ValueError(f"fbank: {key} must be contiguous float32 on {yp.device}")
    kpad, ncols = wbasis_il.shape
    if kpad % K_STEP or not n_fft <= kpad < n_fft + K_STEP or ncols % COL_CHUNK \
            or ncols < 2 * n_bins:
        raise ValueError(f"fbank: wbasis_il {tuple(wbasis_il.shape)} is not the "
                         f"interleaved basis of {tuple(wbasis.shape)}")
    out = torch.empty(B, nf, n_mels, device=yp.device, dtype=torch.float32)
    if B == 0 or nf == 0:
        return out
    if kpad > 4 * hop or n_mels > 64:
        raise ValueError(f"fbank: the kernel takes windows of at most 4 hops and at most 64 mel "
                         f"bands, not n_fft={n_fft}, hop={hop}, n_mels={n_mels}")
    lib = build.load_library()
    err = lib.ss_fbank(
        yp.data_ptr(), wbasis_il.data_ptr(), mel.data_ptr(), out.data_ptr(),
        B, Np, nf, n_fft, hop, n_bins, kpad, ncols, n_mels, LOG_EPS, yp.device.index or 0,
        torch.cuda.current_stream(yp.device).cuda_stream,
    )
    build.check(err, "ss_fbank")
    build.count_launch(LAUNCHES, "fbank")
    return out
