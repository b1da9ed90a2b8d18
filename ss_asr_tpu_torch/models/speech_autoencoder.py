"""Speech autoencoder: global conv encoder + per-listener-frame MLP decoder.

Port of ``ss_asr_tpu/models/speech_autoencoder.py``.  A 3-stage Conv + BN +
ReLU + MaxPool encoder squeezes a whole utterance's fbank into one vector
(the last pool is global: the reference's (2000, 40) kernel); the decoder
MLP maps [one listener frame | global vector] to 8 reconstructed fbank
frames; over the listener's steps that is [B, 8 * (T // 8), feat], scored
with smooth-L1 against the input.  Training it also updates the listener.

``SpeechAutoencoder.state_dict()`` has the reference's keys (``export_sae``
in ``ss_asr_tpu/utils/torch_import.py``): ``encoder.conv_{i}.0.weight``
(OIHW; the JAX tree keeps HWIO), ``encoder.conv_{i}.1.{weight, bias,
running_mean, running_var}``, ``decoder.core.{0,2,4}.*``.  The input is
[B, 1, T, F] (NCHW) where JAX has [B, T, F, 1].

The batch norm is written out: JAX normalises with, and accumulates, the
BIASED batch variance, where ``nn.BatchNorm2d`` accumulates the unbiased
one; momentum 0.1, eps 1e-5.  The running statistics are buffers, updated
in place by a ``train=True`` forward (the JAX package returns a new state).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SAEConfig:
    feature_dim: int = 40
    listener_out_dim: int = 512
    kernel_sizes: Tuple[Tuple[int, int], ...] = ((1, 36), (5, 1), (3, 1))
    num_filters: Tuple[int, ...] = (32, 64, 256)
    pool_kernel_sizes: Tuple[Tuple[int, int], ...] = ((3, 1), (5, 1), (-1, -1))
    frames_per_step: int = 8  # the listener's time reduction

    @property
    def enc_out_dim(self) -> int:
        return self.num_filters[-1]

    @classmethod
    def from_dict(cls, d: dict) -> "SAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        for k in ("kernel_sizes", "pool_kernel_sizes"):
            if k in d:
                d[k] = tuple(tuple(v) for v in d[k])
        if "num_filters" in d:
            d["num_filters"] = tuple(d["num_filters"])
        # the reference's (2000, 40) final pool means "global pool"
        pks = list(d.get("pool_kernel_sizes", cls.pool_kernel_sizes))
        if pks and (pks[-1][0] >= 1000 or pks[-1] == (-1, -1)):
            pks[-1] = (-1, -1)
        d["pool_kernel_sizes"] = tuple(pks)
        return cls(**d)


class BatchNorm(nn.Module):
    """Per-channel scale, bias and running statistics of one batch norm."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """x [B, C, H, W].  ``train``: batch statistics (biased variance),
        which also move the running ones; else the running statistics."""
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.running_mean.copy_((1 - BN_MOMENTUM) * self.running_mean + BN_MOMENTUM * mean)
                self.running_var.copy_((1 - BN_MOMENTUM) * self.running_var + BN_MOMENTUM * var)
        else:
            mean, var = self.running_mean, self.running_var
        c = (None, slice(None), None, None)
        return (x - mean[c]) * torch.rsqrt(var[c] + BN_EPS) * self.weight[c] + self.bias[c]


class SpeechEncoder(nn.Module):
    def __init__(self, cfg: SAEConfig):
        super().__init__()
        in_ch = 1
        for i, (ksz, nf) in enumerate(zip(cfg.kernel_sizes, cfg.num_filters)):
            setattr(self, f"conv_{i + 1}", nn.Sequential(
                nn.Conv2d(in_ch, nf, tuple(ksz), bias=False), BatchNorm(nf)))
            in_ch = nf


class SpeechDecoder(nn.Module):
    def __init__(self, cfg: SAEConfig):
        super().__init__()
        d_in = cfg.enc_out_dim + cfg.listener_out_dim
        self.core = nn.Sequential(
            nn.Linear(d_in, d_in), nn.LeakyReLU(0.01), nn.Linear(d_in, d_in), nn.LeakyReLU(0.01),
            nn.Linear(d_in, cfg.frames_per_step * cfg.feature_dim))


class SpeechAutoencoder(nn.Module):
    def __init__(self, cfg: SAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = SpeechEncoder(cfg)
        self.decoder = SpeechDecoder(cfg)


def speech_encode(model: SpeechAutoencoder, x: torch.Tensor, train: bool) -> torch.Tensor:
    """[B, T, feat] fbank -> [B, enc_out_dim] global vector."""
    cfg = model.cfg
    h = x[:, None, :, :]  # NCHW: [B, 1, T, F]
    for i in range(len(cfg.kernel_sizes)):
        conv, bn = getattr(model.encoder, f"conv_{i + 1}")
        h = torch.relu(bn(F.conv2d(h, conv.weight), train))
        kh, kw = cfg.pool_kernel_sizes[i]
        if kh == -1:  # global pool over all remaining positions
            h = h.amax(dim=(2, 3), keepdim=True)
        else:
            h = F.max_pool2d(h, (kh, kw))  # stride = kernel, floor
    return h.reshape(h.shape[0], -1)


def sae_forward(model: SpeechAutoencoder, x: torch.Tensor, listener_out: torch.Tensor,
                train: bool = True) -> torch.Tensor:
    """Reconstruct fbank frames from [listener steps | global encoding].

    x [B, T, feat]; listener_out [B, S, listener_out_dim] ->
    [B, S * frames_per_step, feat]."""
    cfg = model.cfg
    B, S, _ = listener_out.shape
    g = speech_encode(model, x, train)
    z = torch.cat([listener_out, g[:, None, :].expand(B, S, g.shape[-1])], dim=-1)
    out = model.decoder.core(z)  # one batched MLP over all steps
    return out.reshape(B, S * cfg.frames_per_step, cfg.feature_dim)
