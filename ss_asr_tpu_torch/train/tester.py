"""Test-set decoding with char-LM shallow fusion, and its metrics.

Port of ``ss_asr_tpu/train/tester.py`` on one device: the batches of
``asr.test_index`` (``ASRDataset`` with the config's ``t_bucket`` /
``l_bucket``, ``test_batch_size`` rows, in index order, the last batch
padded) decode greedily (``decode.greedy.greedy_decode_early_exit``: on
the card kernels K2 and K6, or K7 with the LM) or with a beam of
``decode_beam_size`` (``decode.beam.beam_decode``: K2 and K8), fusing
``<ckpdir>/char_lm.npz`` at ``decode_lm_weight`` when that file exists.
The step cap is ``max_decode_steps`` (200), and with
``max_decode_step_ratio`` at most that ratio of the batch's frames
(rounded up to 8, at least 8).  The result is ``<ckpdir>/<decode
file>.txt`` (hypothesis TAB reference, one utterance a line),
``<decode file>_metrics.json`` (``n``, ``acc``, ``wer``, ``cer``) and the
``test_acc`` / ``test_wer`` / ``test_cer`` scalars, where the decode file
is ``decode_beam_<size>[_len_<ratio>]_lm<weight>``.  The JAX package's
fallback to an orbax LM directory is left out, with that backend.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset, round_up
from ss_asr_tpu_torch.decode.beam import beam_decode
from ss_asr_tpu_torch.decode.greedy import greedy_decode_early_exit
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.train.solver import Solver
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from ss_asr_tpu_torch.utils.metrics import char_acc_row, err_rate, with_terminal_eos


def _mean_err(hyps: List[str], refs: List[str], unit: str) -> float:
    """Mean per-utterance edit-distance error: ``unit="word"`` the thesis'
    WER (may exceed 1), ``unit="char"`` the CER."""
    if not hyps:
        return 0.0
    return float(np.mean([err_rate(h, r, unit) for h, r in zip(hyps, refs)]))


class ASRTester(Solver):
    def __init__(self, config, paras, device: str = "cuda"):
        super().__init__(config, paras, "asr", device)
        c = config["asr"]
        # the file name states the policy applied: no ratio, no "len" tag
        parts = ["decode", "beam", str(c.get("decode_beam_size", 1))]
        if c.get("max_decode_step_ratio"):
            parts += ["len", str(c["max_decode_step_ratio"])]
        self.decode_file = "_".join(parts)

    def load_data(self):
        c = self.config["asr"]
        self.test_ds = ASRDataset(c["test_index"], batch_size=max(self.test_batch_size, 1),
                                  t_bucket=c.get("t_bucket", 128), l_bucket=c.get("l_bucket", 16))
        self.mapper = self.test_ds.mapper

    def set_model(self):
        c = self.config["asr"]
        self.cfg = las.ASRConfig.from_dict(c["mdl"])
        model = las.LAS(self.cfg)
        tree = self.setup_params(convert.asr_params_from_state(model.state_dict()),
                                 lambda seed: convert.init_asr_numpy(seed, self.cfg), self.ckppath)
        model.load_state_dict(convert.asr_state_from_params(tree))
        self.model = model.to(self.device).eval()

        # the char-LM's sizes under char_lm.mdl, or directly under char_lm
        lm_c = self.config.get("char_lm", {})
        self.lm_cfg = charlm.CharLMConfig.from_dict(lm_c.get("mdl", lm_c))
        lm_path = os.path.join(self.ckpdir, "char_lm.npz")
        if ckpt.exists(lm_path):
            lm = charlm.CharLM(self.lm_cfg)
            lm.load_state_dict(convert.charlm_state_from_params(ckpt.load_pytree(lm_path)))
            self.lm = lm.to(self.device).eval()
        else:
            self.verbose(f"No char LM at {lm_path}; decoding without fusion")
            self.lm = None

        self.lm_weight = c.get("decode_lm_weight", 0.0)
        self.decode_beam_size = c.get("decode_beam_size", 1)
        self.max_decode_steps = c.get("max_decode_steps", 200)
        self.decode_step_ratio = c.get("max_decode_step_ratio", None)
        self.decode_file += "_lm{}".format(self.lm_weight)

    def exec(self, lm_weight=None) -> List[str]:
        if lm_weight is None:
            lm_weight = self.lm_weight
        use_lm = self.lm is not None and lm_weight != 0.0
        self.verbose(f"Start decoding (beam size {self.decode_beam_size}, "
                     f"lm_weight {lm_weight if use_lm else 0})")
        results: List[str] = []
        refs: List[str] = []
        accs: List[float] = []
        for b in self.test_ds.iter_batches(drop_last=False, shuffle=False):
            toks, lens = self._decode_batch(b, lm_weight if use_lm else 0.0)
            valid = b.valid if b.valid is not None else np.ones(toks.shape[0], bool)
            for i in range(toks.shape[0]):
                if not valid[i]:
                    continue
                results.append(self.mapper.translate(toks[i]))
                refs.append(self.mapper.translate(b.y[i]))
                accs.append(char_acc_row(with_terminal_eos(toks[i], lens[i]), b.y[i][1:]))

        self.metrics: Dict[str, float] = {
            "n": len(results),
            "acc": float(np.mean(accs)) if accs else 0.0,
            "wer": _mean_err(results, refs, "word"),
            "cer": _mean_err(results, refs, "char"),
        }
        out_path = os.path.join(self.ckpdir, self.decode_file + ".txt")
        with open(out_path, "w", encoding="utf-8") as f:
            for hyp, ref in zip(results, refs):
                f.write(f"{hyp}\t{ref}\n")
        with open(os.path.join(self.ckpdir, self.decode_file + "_metrics.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.metrics, f, indent=1)
        for k in ("acc", "wer", "cer"):
            self.lg.scalar(f"test_{k}", self.metrics[k], self.tr.step)
        self.verbose(f"Decoded {len(results)} utterances -> {out_path} | "
                     f"acc {self.metrics['acc']:.4f} wer {self.metrics['wer']:.4f} "
                     f"cer {self.metrics['cer']:.4f}")
        return results

    def _max_steps_for(self, b) -> int:
        ms = self.max_decode_steps
        if self.decode_step_ratio:
            ms = min(ms, max(8, round_up(int(self.decode_step_ratio * b.x.shape[1]), 8)))
        return ms

    def _decode_batch(self, b, lm_weight):
        """-> (tokens [B, max_steps], lengths [B]) as numpy arrays."""
        max_steps = self._max_steps_for(b)
        x = torch.from_numpy(b.x).to(self.device)
        x_lens = torch.from_numpy(b.x_lens).to(self.device)
        lm = self.lm if lm_weight else None
        if self.decode_beam_size > 1:
            return beam_decode(self.model, x, x_lens, beam_size=self.decode_beam_size,
                               max_steps=max_steps, lm=lm, lm_weight=lm_weight)
        with torch.inference_mode():
            toks, lens = greedy_decode_early_exit(self.model, x, x_lens, max_steps=max_steps,
                                                  lm=lm, lm_weight=lm_weight)
        return toks.cpu().numpy(), lens.cpu().numpy()

    def close(self):
        self.lg.close()
