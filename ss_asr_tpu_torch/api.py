"""High-level inference API: checkpoint -> transcripts.

    from ss_asr_tpu_torch.api import Transcriber
    t = Transcriber.from_checkpoint("asr.npz", config, beam_size=1)
    print(t.transcribe_wav("utt.wav"))

Port of ``ss_asr_tpu/api.py`` ``Transcriber``, greedy subset: the batched
frontend, the listener and the greedy decode (± char-LM fusion) run on the
model's device — the CUDA kernels on a GPU, their plain versions on the CPU.
The signal/frame bucketing (``sr``, ``t_bucket``, the 500 ms sample grid)
and the empty-row rules are the JAX package's.  Beam search, mesh serving,
the detailed / long-form / streaming decodes raise ``NotImplementedError``
naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.audio import load_wav
from ss_asr_tpu_torch.decode.greedy import greedy_decode_early_exit
from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_batch
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from ss_asr_tpu_torch.vocab import Mapper

BEAM_TODO = "ROADMAP.md port item 2 (beam search: the beam kernel K8 and decode/beam.py)"
DETAIL_TODO = "ROADMAP.md port item 3 (n-best, alignment and rescoring)"
LONG_TODO = "ROADMAP.md port item 4 (long-form and streaming decode)"
MESH_TODO = "ROADMAP.md port item 9 (data-parallel serving and training)"


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Transcriber:
    def __init__(
        self,
        model: las.LAS,
        lm: Optional[charlm_mod.CharLM] = None,
        lm_weight: float = 0.0,
        beam_size: int = 1,
        max_steps: int = 200,
        sr: int = 22050,
        t_bucket: int = 128,
        mesh=None,
    ):
        """``model`` (and ``lm``) already on their device; decoding runs
        there.  Only greedy decoding (``beam_size=1``) is ported."""
        if beam_size > 1:
            raise NotImplementedError(
                f"beam_size={beam_size}: beam search is not ported yet, see "
                f"{BEAM_TODO}; pass beam_size=1")
        if mesh is not None:
            raise NotImplementedError(f"mesh serving is not ported yet, see {MESH_TODO}")
        self.model = model.eval()
        self.lm = lm.eval() if lm is not None else None
        self.cfg = model.cfg
        self.lm_cfg = lm.cfg if lm is not None else None
        self.lm_weight = lm_weight
        self.beam_size = beam_size
        self.max_steps = max_steps
        self.sr = sr
        self.t_bucket = t_bucket
        self.device = model.embed.weight.device
        self.mapper = Mapper()

    @classmethod
    def from_checkpoint(
        cls,
        asr_path: str,
        config: Optional[dict] = None,
        lm_path: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
        **kw,
    ) -> "Transcriber":
        """Load npz checkpoints in the JAX tree layout onto ``device``.
        ``beam_size`` follows the config's ``decode_beam_size`` as in JAX,
        so a caller of this greedy-only port passes ``beam_size=1``."""
        config = config or {}
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        cfg = las.ASRConfig.from_dict(config.get("asr", {}).get("mdl", {}))
        kw.setdefault("beam_size", config.get("asr", {}).get("decode_beam_size", 1))
        if kw["beam_size"] > 1:
            raise NotImplementedError(
                f"beam_size={kw['beam_size']} (from the config's decode_beam_size): beam "
                f"search is not ported yet, see {BEAM_TODO}; pass beam_size=1")
        model = las.LAS(cfg)
        model.load_state_dict(convert.asr_state_from_params(ckpt.load_pytree(asr_path)))
        lm = None
        if lm_path is not None:
            lm_c = config.get("char_lm", {})
            lm = charlm_mod.CharLM(charlm_mod.CharLMConfig.from_dict(lm_c.get("mdl", lm_c)))
            lm.load_state_dict(convert.charlm_state_from_params(ckpt.load_pytree(lm_path)))
            lm = lm.to(device)
            kw.setdefault("lm_weight", config.get("asr", {}).get("decode_lm_weight", 0.5))
        return cls(model.to(device), lm=lm, **kw)

    # ------------------------------------------------------------------
    def _decode(self, x: torch.Tensor, lens: torch.Tensor) -> np.ndarray:
        use_lm = self.lm is not None and self.lm_weight != 0.0
        with torch.inference_mode():
            toks, _ = greedy_decode_early_exit(
                self.model, x, lens, max_steps=self.max_steps,
                lm=self.lm if use_lm else None, lm_weight=self.lm_weight)
        return toks.cpu().numpy()

    def _prepare_batch(self, fbanks):
        """fbank list -> None when every row is empty, else
        ``(empty_mask, x [B, T_bucketed, feat], lens)`` on the device."""
        lens = np.array([f.shape[0] for f in fbanks], dtype=np.int32)
        if int(lens.max()) == 0:
            return None
        T = round_up(int(lens.max()), self.t_bucket)
        x = np.zeros((len(fbanks), T, self.cfg.feature_dim), dtype=np.float32)
        for i, f in enumerate(fbanks):
            x[i, : f.shape[0]] = f
        return (lens == 0, torch.from_numpy(x).to(self.device),
                torch.from_numpy(lens).to(self.device))

    def transcribe_fbank(
        self, fbanks: Union[np.ndarray, Sequence[np.ndarray]]
    ) -> List[str]:
        """[T, feat] or list thereof -> transcripts."""
        if isinstance(fbanks, np.ndarray) and fbanks.ndim == 2:
            fbanks = [fbanks]
        fbanks = list(fbanks)
        if not fbanks:
            return []
        prep = self._prepare_batch(fbanks)
        if prep is None:
            return ["" for _ in fbanks]
        empty, x, lens = prep
        out = [self.mapper.translate(t) for t in self._decode(x, lens)]
        # a zero-frame row has no audio to attend to: its transcript is ""
        return ["" if e else o for e, o in zip(empty, out)]

    def transcribe_signal_batch(
        self,
        signals: Sequence[np.ndarray],
        sr: Optional[int] = None,
        s_bucket_ms: int = 500,
    ) -> List[str]:
        """Batch of raw waveforms -> transcripts (frontend + greedy decode).
        Signal buffers bucket to an ``s_bucket_ms`` grid."""
        sr = sr or self.sr
        signals = [np.asarray(s, dtype=np.float32).reshape(-1) for s in signals]
        if not signals:
            return []
        lens = np.array([len(s) for s in signals], dtype=np.int32)
        if int(lens.max()) == 0:
            return ["" for _ in signals]
        step = max(int(sr * s_bucket_ms) // 1000, 1)
        S = -(-int(lens.max()) // step) * step
        buf = np.zeros((len(signals), S), dtype=np.float32)
        for i, s in enumerate(signals):
            buf[i, : len(s)] = s
        buf_d = torch.from_numpy(buf).to(self.device)
        lens_d = torch.from_numpy(lens).to(self.device)
        with torch.inference_mode():
            fb, fl = log_mel_fbank_batch(buf_d, lens_d, sr, n_mels=self.cfg.feature_dim)
        out = [self.mapper.translate(t) for t in self._decode(fb, fl)]
        # a zero-sample row has no audio (same contract as transcribe_fbank)
        return ["" if n == 0 else o for n, o in zip(lens, out)]

    def transcribe_signal(self, y: np.ndarray, sr: Optional[int] = None) -> str:
        return self.transcribe_signal_batch([y], sr=sr)[0]

    def transcribe_wav(self, path: str) -> str:
        sr, y = load_wav(path, target_sr=self.sr)
        return self.transcribe_signal(y, sr)

    def transcribe_fbank_detailed(self, fbanks, n_best: int = 1, timestamps: bool = True):
        raise NotImplementedError(f"transcribe_fbank_detailed is not ported yet, see {DETAIL_TODO}")

    def transcribe_long(self, y, sr=None, window_s=20.0, overlap_s=2.0, vad=None) -> str:
        raise NotImplementedError(f"transcribe_long is not ported yet, see {LONG_TODO}")

    def transcribe_stream(self, chunks, sr=None) -> str:
        raise NotImplementedError(f"transcribe_stream is not ported yet, see {LONG_TODO}")
