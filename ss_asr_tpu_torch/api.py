"""High-level inference API: checkpoint -> transcripts.

    from ss_asr_tpu_torch.api import Transcriber
    t = Transcriber.from_checkpoint("asr.npz", config)
    print(t.transcribe_wav("utt.wav"))

Port of ``ss_asr_tpu/api.py`` ``Transcriber``: the batched frontend, the
listener and the decode (greedy or beam, ± char-LM fusion) run on the
model's device — the CUDA kernels on a GPU, their plain versions on the
CPU; plus the detailed (n-best, confidence, timestamps), long-form and
streaming decodes.  The signal/frame bucketing (``sr``, ``t_bucket``, the
500 ms sample grid) and the empty-row rules are the JAX package's.

``mesh=`` (``parallel.mesh.Mesh`` with a ``data`` axis) serves the rows
over several devices, as the JAX package's mesh ``Transcriber`` does: the
(ASR, LM) pair is placed on each mesh device once, a batch is padded to a
multiple of the axis with zero-length rows, each row shard decodes on its
device through the same kernels as a plain batch, and the rows join in
order.  The shards run one after another from the calling thread; a shard
of padding rows alone is not decoded.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.audio import load_wav
from ss_asr_tpu_torch.decode import align as align_mod
from ss_asr_tpu_torch.decode.beam import beam_decode, beam_decode_nbest
from ss_asr_tpu_torch.decode.greedy import greedy_decode_early_exit
from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops.frontend import log_mel_fbank_batch
from ss_asr_tpu_torch.ops.kernels.beam import MAX_BEAM
from ss_asr_tpu_torch.parallel.mesh import DATA_AXIS
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from ss_asr_tpu_torch.vocab import Mapper


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
        there, or with ``mesh`` on the mesh's devices.  ``beam_size`` > 1
        decodes with a beam of that width (at most ``MAX_BEAM``, the widest
        the beam kernel takes)."""
        if not 1 <= beam_size <= MAX_BEAM:
            raise ValueError(f"beam_size {beam_size} outside 1..{MAX_BEAM}")
        self.mesh = mesh
        self.device = model.embed.weight.device
        if mesh is not None:
            names = tuple(getattr(mesh, "axis_names", ()))
            if DATA_AXIS not in names:
                raise ValueError(f"mesh needs a '{DATA_AXIS}' axis, has {names}")
            self._slots = tuple(mesh.data_devices)
        else:
            self._slots = (self.device,)
        #: the (ASR, LM) pair and its replica on each mesh device, in ONE
        #: tuple, so a hot reload swaps them all at once; every decode reads
        #: it once per call (no torn pair)
        self._w = self.replicate(model.eval(), lm.eval() if lm is not None else None)
        self.cfg = model.cfg
        self.lm_cfg = lm.cfg if lm is not None else None
        self.lm_weight = lm_weight
        self.beam_size = beam_size
        self.max_steps = max_steps
        self.sr = sr
        self.t_bucket = t_bucket
        self.mapper = Mapper()

    def replicate(self, model, lm) -> tuple:
        """``(model, lm, replicas)``: replicas[i] the pair on the mesh's i-th
        device, copied once per distinct device (the pair itself on its own)."""
        on = {self.device: (model, lm)}
        for d in self._slots:
            if d not in on:
                on[d] = (copy.deepcopy(model).to(d).eval(),
                         copy.deepcopy(lm).to(d).eval() if lm is not None else None)
        return model, lm, tuple(on[d] for d in self._slots)

    @property
    def model(self) -> las.LAS:
        return self._w[0]

    @property
    def lm(self) -> Optional[charlm_mod.CharLM]:
        return self._w[1]

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
        ``beam_size`` and ``lm_weight`` follow the config's
        ``decode_beam_size`` / ``decode_lm_weight`` unless given."""
        config = config or {}
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        cfg = las.ASRConfig.from_dict(config.get("asr", {}).get("mdl", {}))
        model = las.LAS(cfg)
        model.load_state_dict(convert.asr_state_from_params(ckpt.load_pytree(asr_path)))
        lm = None
        if lm_path is not None:
            lm_c = config.get("char_lm", {})
            lm = charlm_mod.CharLM(charlm_mod.CharLMConfig.from_dict(lm_c.get("mdl", lm_c)))
            lm.load_state_dict(convert.charlm_state_from_params(ckpt.load_pytree(lm_path)))
            lm = lm.to(device)
            kw.setdefault("lm_weight", config.get("asr", {}).get("decode_lm_weight", 0.5))
        kw.setdefault("beam_size", config.get("asr", {}).get("decode_beam_size", 1))
        return cls(model.to(device), lm=lm, **kw)

    # ------------------------------------------------------------------
    def _fused_lm(self, lm):
        """(LM, weight) the decode fuses: none when there is no LM or its
        weight is 0."""
        if lm is None or self.lm_weight == 0.0:
            return None, 0.0
        return lm, self.lm_weight

    def _decode(self, x: torch.Tensor, lens: torch.Tensor, model, lm) -> np.ndarray:
        lm, lmw = self._fused_lm(lm)
        if self.beam_size > 1:
            toks, _ = beam_decode(model, x, lens, beam_size=self.beam_size,
                                  max_steps=self.max_steps, lm=lm, lm_weight=lmw)
            return toks
        with torch.inference_mode():
            toks, _ = greedy_decode_early_exit(model, x, lens, max_steps=self.max_steps,
                                               lm=lm, lm_weight=lmw)
        return toks.cpu().numpy()

    def _over_mesh(self, items: list, rows_fn, pad_row) -> list:
        """``rows_fn(items, model, lm, pad_len)`` over the rows, on the mesh's
        devices: ``items`` padded with ``pad_row`` (zero length) up to a
        multiple of the data axis, one contiguous shard a device, the
        results joined in order.  ``pad_len``, the longest item, sets every
        shard's bucketed length, as one batch would."""
        replicas = self._w[2]  # one snapshot: no torn (ASR, LM) pair
        pad_len = max(len(x) for x in items)
        if len(replicas) == 1:
            return rows_fn(items, *replicas[0], pad_len)
        n_real, per = len(items), -(-len(items) // len(replicas))
        items = items + [pad_row] * (per * len(replicas) - n_real)
        out = []
        for i, (m, l) in enumerate(replicas):
            out.extend(rows_fn(items[i * per:(i + 1) * per], m, l, pad_len))
        return out[:n_real]

    def _prepare_batch(self, fbanks, device, pad_len: int):
        """fbank list -> None when every row is empty, else
        ``(empty_mask, x [B, T_bucketed, feat], lens)`` on ``device``."""
        lens = np.array([f.shape[0] for f in fbanks], dtype=np.int32)
        if int(lens.max()) == 0:
            return None
        T = round_up(pad_len, self.t_bucket)
        x = np.zeros((len(fbanks), T, self.cfg.feature_dim), dtype=np.float32)
        for i, f in enumerate(fbanks):
            x[i, : f.shape[0]] = f
        return lens == 0, torch.from_numpy(x).to(device), torch.from_numpy(lens).to(device)

    @staticmethod
    def _fbank_list(fbanks) -> list:
        if isinstance(fbanks, np.ndarray) and fbanks.ndim == 2:
            return [fbanks]
        return list(fbanks)

    def _empty_fbank(self) -> np.ndarray:
        return np.zeros((0, self.cfg.feature_dim), np.float32)

    def transcribe_fbank(
        self, fbanks: Union[np.ndarray, Sequence[np.ndarray]]
    ) -> List[str]:
        """[T, feat] or list thereof -> transcripts."""
        fbanks = self._fbank_list(fbanks)
        if not fbanks:
            return []
        return self._over_mesh(fbanks, self._fbank_rows, self._empty_fbank())

    def _fbank_rows(self, fbanks, model, lm, pad_len) -> List[str]:
        prep = self._prepare_batch(fbanks, model.embed.weight.device, pad_len)
        if prep is None:
            return ["" for _ in fbanks]
        empty, x, lens = prep
        out = [self.mapper.translate(t) for t in self._decode(x, lens, model, lm)]
        # a zero-frame row has no audio to attend to: its transcript is ""
        return ["" if e else o for e, o in zip(empty, out)]

    def transcribe_fbank_detailed(
        self,
        fbanks: Union[np.ndarray, Sequence[np.ndarray]],
        n_best: int = 1,
        timestamps: bool = True,
    ) -> List[List[align_mod.Hypothesis]]:
        """n-best hypotheses with scores, confidence and per-character
        timestamps, one ``List[Hypothesis]`` per input (best first).

        ``n_best`` > 1 decodes with a beam of ``max(beam_size, n_best)``
        and returns its frontier.  With ``timestamps`` every hypothesis
        carries ``char_starts`` (seconds) and an ``avg_logprob`` from one
        batched teacher-forced alignment pass; without, the timing arrays
        are empty and score / avg_logprob are the beam search's own, or
        NaN on the greedy path (greedy computes no score)."""
        if n_best < 1:
            raise ValueError(f"n_best must be >= 1, got {n_best}")
        fbanks = self._fbank_list(fbanks)
        if not fbanks:
            return []
        return self._over_mesh(
            fbanks, lambda f, m, l, p: self._detailed_rows(f, m, l, p, n_best, timestamps),
            self._empty_fbank())

    def _detailed_rows(self, fbanks, model, lm, pad_len, n_best, timestamps):
        empty_hyp = align_mod.Hypothesis(
            text="", score=0.0, avg_logprob=0.0,
            char_starts=np.zeros((0,), np.float32), char_frames=np.zeros((0,), np.int32))
        prep = self._prepare_batch(fbanks, model.embed.weight.device, pad_len)
        if prep is None:
            return [[empty_hyp] for _ in fbanks]
        empty, x, lens = prep
        lm, lmw = self._fused_lm(lm)
        beam = n_best > 1 or self.beam_size > 1
        if beam:
            toks, tok_lens, scores = beam_decode_nbest(
                model, x, lens, beam_size=max(self.beam_size, n_best),
                max_steps=self.max_steps, lm=lm, lm_weight=lmw, n_best=n_best)
        else:
            with torch.inference_mode():
                g_toks, g_lens = greedy_decode_early_exit(
                    model, x, lens, max_steps=self.max_steps, lm=lm, lm_weight=lmw)
            toks = g_toks.cpu().numpy()[:, None, :]
            tok_lens = g_lens.cpu().numpy()[:, None].astype(np.int32)
            scores = np.full(tok_lens.shape, np.nan, np.float32)
        n = toks.shape[1]

        # one alignment pass over all B * n hypotheses; the character
        # length is bucketed to 16
        L = int(tok_lens.max())
        if timestamps and L > 0:
            Lb = round_up(L, 16)
            ids3 = toks[:, :, :Lb]
            if ids3.shape[2] < Lb:
                ids3 = np.pad(ids3, ((0, 0), (0, 0), (0, Lb - ids3.shape[2])))
            frames, logp = align_mod.force_align_nbest(model, x, lens, ids3, lm=lm,
                                                       lm_weight=lmw)
        out: List[List[align_mod.Hypothesis]] = []
        for b in range(len(fbanks)):
            if empty[b]:
                out.append([empty_hyp])
                continue
            if timestamps and L > 0:
                hyps = align_mod.build_hypotheses(self.mapper, toks[b], tok_lens[b], frames[b],
                                                  logp[b])
                if beam:
                    # keep the decoder's own (EOS-inclusive) ranking score;
                    # avg_logprob stays the alignment pass's confidence
                    for j, h in enumerate(hyps):
                        h.score = float(scores[b, j])
            else:
                hyps = [
                    align_mod.Hypothesis(
                        text=self.mapper.translate(toks[b, j]),
                        score=float(scores[b, j]),
                        avg_logprob=float(scores[b, j]) / max(int(tok_lens[b, j]), 1),
                        char_starts=np.zeros((0,), np.float32),
                        char_frames=np.zeros((0,), np.int32),
                    )
                    for j in range(n)
                ]
            out.append(hyps)
        return out

    def transcribe_signal_batch(
        self,
        signals: Sequence[np.ndarray],
        sr: Optional[int] = None,
        s_bucket_ms: int = 500,
    ) -> List[str]:
        """Batch of raw waveforms -> transcripts (frontend + decode).
        Signal buffers bucket to an ``s_bucket_ms`` grid."""
        sr = sr or self.sr
        signals = [np.asarray(s, dtype=np.float32).reshape(-1) for s in signals]
        if not signals:
            return []
        return self._over_mesh(
            signals, lambda y, m, l, p: self._signal_rows(y, m, l, p, sr, s_bucket_ms),
            np.zeros((0,), np.float32))

    def _signal_rows(self, signals, model, lm, pad_len, sr, s_bucket_ms) -> List[str]:
        lens = np.array([len(s) for s in signals], dtype=np.int32)
        if int(lens.max()) == 0:
            return ["" for _ in signals]
        step = max(int(sr * s_bucket_ms) // 1000, 1)
        S = -(-pad_len // step) * step
        buf = np.zeros((len(signals), S), dtype=np.float32)
        for i, s in enumerate(signals):
            buf[i, : len(s)] = s
        device = model.embed.weight.device
        buf_d = torch.from_numpy(buf).to(device)
        lens_d = torch.from_numpy(lens).to(device)
        with torch.inference_mode():
            fb, fl = log_mel_fbank_batch(buf_d, lens_d, sr, n_mels=self.cfg.feature_dim)
        out = [self.mapper.translate(t) for t in self._decode(fb, fl, model, lm)]
        # a zero-sample row has no audio (same contract as transcribe_fbank)
        return ["" if n == 0 else o for n, o in zip(lens, out)]

    def transcribe_signal(self, y: np.ndarray, sr: Optional[int] = None) -> str:
        return self.transcribe_signal_batch([y], sr=sr)[0]

    def transcribe_wav(self, path: str) -> str:
        sr, y = load_wav(path, target_sr=self.sr)
        return self.transcribe_signal(y, sr)

    def transcribe_stream(self, chunks, sr: Optional[int] = None) -> str:
        """Long-form audio from an iterable of sample chunks: the frontend
        runs incrementally (``ops.frontend.StreamingFrontend``, frames equal
        to the one-shot frontend's) on this transcriber's device, and the
        assembled frames decode once."""
        from ss_asr_tpu_torch.ops.frontend import StreamingFrontend

        fe = StreamingFrontend(sr or self.sr, n_mels=self.cfg.feature_dim, device=self.device)
        parts = [fe.push(c) for c in chunks]
        parts.append(fe.close())
        return self.transcribe_fbank(np.concatenate(parts, 0))[0]

    def transcribe_long(
        self,
        y: np.ndarray,
        sr: Optional[int] = None,
        window_s: float = 20.0,
        overlap_s: float = 2.0,
        vad: Optional[str] = None,
    ) -> str:
        """Long-form audio: windows decoded as ONE batch, transcripts joined
        (``decode.longform``).

        Default: fixed overlapping windows, merged over the overlap.
        ``vad="energy"``: cut at low-energy points instead; the segments are
        disjoint (``overlap_s``, floored at ``window_s / 10``, becomes the
        shortest segment) and their transcripts join with a space.  Audio
        shorter than one window takes the plain path."""
        from ss_asr_tpu_torch.decode.longform import (
            energy_segments, merge_window_texts, window_bounds,
        )
        from ss_asr_tpu_torch.ops.frontend import compute_fbank

        if vad not in (None, "energy"):
            raise ValueError(f"vad must be None or 'energy', got {vad!r}")
        sr = sr or self.sr
        y = np.asarray(y, dtype=np.float32).reshape(-1)
        if y.size == 0:
            return ""
        win = max(1, int(window_s * sr))
        ov = max(0, min(int(overlap_s * sr), win - 1))
        if vad == "energy":
            # floor at win / 10: overlap_s = 0 would allow 1-sample segments
            bounds = energy_segments(y, sr, max_window=win, min_window=max(1, ov, win // 10))
        else:
            bounds = window_bounds(len(y), win, ov)
        if len(bounds) == 1:
            return self.transcribe_signal(y, sr)
        # the frontend once over the whole signal, frames sliced per window
        fb = compute_fbank(y, sr, n_mels=self.cfg.feature_dim, device=self.device)
        hop = sr // 100  # 10 ms frontend stride
        rows = []
        for s, e in bounds:
            fs, fe_ = s // hop, min(max(e // hop, s // hop + 1), fb.shape[0])
            rows.append(fb[fs:fe_])
        texts = self.transcribe_fbank(rows)
        if vad == "energy":
            return " ".join(t for t in texts if t)
        return merge_window_texts(texts, overlap_frac=ov / win)
