"""Supervised LAS training.

Port of ``ss_asr_tpu/train/asr_trainer.py``.  A train step:
with an ``asr.augment`` section, SpecAugment of the features
(``ops/augment.py``); ``asr_forward`` with teacher ``y`` at the config's
``tf_rate``, ``masked_ce_per_utt``, the backward (on the card: kernels K2 /
K3 for the listener, K9 / K10 for the speller), then clip + Adadelta under
the NaN skip (``train/optim.py``), with the ``opt`` section's gradient
accumulation and learning-rate schedule.  The step's random draws come from
the solver's generator on the host, moved to the device, in this order:
the augment's four uniforms (``augment.draw_uniforms``), then the
scheduled-sampling draws (``las.draw_scheduled_sampling``).  The tracker's
step counts calls (micro-batches), as the JAX trainer's does.
Data parallel (``parallel: {n_data: N}``, one rank per device): each rank
trains on its shard of the index; a step pads the targets to the longest
over the ranks, draws for the global batch and keeps its rows, and averages
the gradients and the loss over the ranks before the optimizer's step
(``Solver``).  Validation stays whole-corpus on every rank, so that the
eval metrics agree without a gather.
Tensor parallel (``parallel: {n_data: D, n_model: M}``, D x M ranks): the
ranks of a model group train on the same rows, the optimizer holds the
rank's shards (``Solver.place_tp``), and the model's full weights, which
the kernels, ``valid()`` and the checkpoints read, are gathered from them
after every update; a save gathers the optimizer's slots too.
Validation decodes with greedy feedback for ``L - 1 + 30`` steps (the
reference's free-run margin) and scores the first ``L - 1``.

Checkpoints are the JAX package's: ``asr.npz`` (the parameter tree),
``asr_opt.npz`` (the optax state's leaves), ``asr_best.npz``,
``tracker.json``.  torch keeps two biases per LSTM where JAX keeps one:
the loaded tree's bias goes to ``bias_ih`` and ``bias_hh`` stays frozen at
zero, so the trainer trains exactly the JAX package's 36 leaves (a second
trainable bias would move twice per step and count twice in the clip's
global norm).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.train import losses
from ss_asr_tpu_torch.ops import augment
from ss_asr_tpu_torch.train.solver import Solver, make_optim
from ss_asr_tpu_torch.utils import checkpoint as ckpt
from ss_asr_tpu_torch.utils.metrics import calc_acc, calc_cer, calc_err, draw_att
from ss_asr_tpu_torch.utils.profiling import StepTimer


class ASRTrainer(Solver):
    def __init__(self, config, paras, device: str = "cuda"):
        super().__init__(config, paras, "asr", device)

    def load_data(self):
        c = self.config["asr"]
        tb, lb = c.get("t_bucket", 128), c.get("l_bucket", 16)
        self.train_ds = ASRDataset(c["train_index"], batch_size=self.train_batch_size,
                                   t_bucket=tb, l_bucket=lb, host_shard=self.host_shard)
        self.valid_ds = ASRDataset(c["valid_index"], batch_size=self.valid_batch_size,
                                   t_bucket=tb, l_bucket=lb)
        self.mapper = self.train_ds.mapper
        self.wer_step = c.get("wer_step", 50)

    def set_model(self):
        c = self.config["asr"]
        self.aug_cfg = augment.SpecAugmentConfig.from_dict(c.get("augment"))
        self.cfg = las.ASRConfig.from_dict(c["mdl"])
        model = las.LAS(self.cfg)
        tree = self.setup_params(convert.asr_params_from_state(model.state_dict()),
                                 lambda seed: convert.init_asr_numpy(seed, self.cfg), self.ckppath)
        model.load_state_dict(convert.asr_state_from_params(tree))  # bias_hh = 0
        for name, p in model.named_parameters():
            p.requires_grad_(".bias_hh" not in name)
        self.model = model.to(self.device)
        self.optim = make_optim([(n, p) for n, p in self.model.named_parameters()
                                 if p.requires_grad], c["opt"])
        if self.loaded_ckpt and ckpt.exists(self.opt_ckppath):
            self.verbose(f"Restoring optimizer state from {self.opt_ckppath}")
            if not convert.load_asr_opt_state_leaves(self.optim, self.model,
                                                     ckpt.load_opt_state(self.opt_ckppath)):
                self.verbose("Optimizer state does not fit this optimizer; starting it fresh")
        self.broadcast_state([self.model], [self.optim])
        if self.tp is not None:
            self.optim = self.place_tp(self.model, self.optim)

    def params_tree(self):
        return convert.asr_params_from_state(self.model.state_dict())

    def save_state(self):
        optim = self.optim if self.tp is None else self.tp_gathered(self.model, self.optim)
        super().save_state(self.params_tree(), convert.asr_opt_state_leaves(optim, self.model))

    def _placed(self, b):
        return (torch.from_numpy(b.x).to(self.device), torch.from_numpy(b.x_lens).to(self.device),
                torch.from_numpy(b.y).to(self.device).long())

    def train_step(self, b):
        """One update on batch ``b`` -> (loss, logits), both detached."""
        return self.step(*self._placed(b))

    def step(self, x: torch.Tensor, x_lens: torch.Tensor, y: torch.Tensor):
        """One update on a batch already on the device: fbanks x [B, T,
        feat], x_lens [B], targets y [B, L + 1] (SOS first) -> (loss,
        logits), both detached."""
        L_own = y.shape[1] - 1
        L = self.global_width(L_own)
        if L > L_own:  # SOS padding: masked out of the loss
            y = torch.nn.functional.pad(y, (0, L - L_own))
        Bg, rows = self.global_rows(y.shape[0])
        if self.aug_cfg is not None:  # the training features only; valid() sees clean ones
            draws = augment.draw_uniforms(Bg, self.aug_cfg, self.generator, x.device)
            if rows is not None:
                draws = tuple(d[rows] for d in draws)
            x = augment.spec_augment(x, x_lens, self.aug_cfg, draws=draws)
        tf_draws, gumbel = las.draw_scheduled_sampling(L, Bg, self.cfg.tf_rate, self.cfg,
                                                       self.generator, device=self.device)
        if rows is not None:
            gumbel = gumbel[:, rows].contiguous()
        self.model.zero_grad(set_to_none=True)
        _, logits, _ = las.asr_forward(self.model, x, x_lens, L, teacher=y, tf_draws=tf_draws,
                                       gumbel=gumbel)
        loss = losses.masked_ce_per_utt(logits, y[:, 1:], y)
        loss.backward()
        if self.tp is not None:
            self.tp_grads(self.model, self.optim)
        (loss,) = self.dp_average(self.optim.params.values(), loss.detach())
        self.optim.step()
        if self.tp is not None:
            self.tp_sync(self.model, self.optim)
        return loss.detach(), logits.detach()[:, :L_own]

    def exec(self):
        self.verbose(f"Training set total {len(self.train_ds)} batches")
        timer = StepTimer()
        for epoch in range(self.n_epochs):
            self.verbose(f"Starting epoch {epoch + 1} out of {self.n_epochs}")
            # data parallel: rotate the shard, then agree on the number of steps
            self.train_ds.set_epoch(epoch)
            n_steps = self.global_min_batches(len(self.train_ds))
            for b_ind, b in enumerate(self.train_ds.iter_batches()):
                if b_ind >= n_steps:
                    break
                self.verbose(f"Batch: {b_ind}/{len(self.train_ds)}, global step: {self.tr.step}",
                             progress=True)
                loss, logits = self.train_step(b)
                timer.tick()
                label = b.y[:, 1:]
                if self.tr.step % self.logging_step == 0:
                    self.lg.scalar("train_loss", float(loss), self.tr.step)
                    self.lg.scalar("train_acc", calc_acc(logits.cpu().numpy(), label), self.tr.step)
                    if timer.steps_per_sec > 0:
                        self.lg.scalar("train_utt_per_sec", timer.utt_per_sec(b.y.shape[0]),
                                       self.tr.step)
                if self.tr.step % self.wer_step == 0:
                    self.lg.scalar("train_error",
                                   calc_err(logits.cpu().numpy(), label, mapper=self.mapper),
                                   self.tr.step)
                if self.tr.step % self.save_step == 0:
                    self.verbose(f"Model saved at step {self.tr.step}")
                    self.save_state()
                if self.tr.step % self.valid_step == 0:
                    self.valid()
                self.tr.do_step()

    @torch.no_grad()
    def valid(self):
        # per-utterance accumulation: every utterance weighs the same
        # regardless of batch fill
        total_loss, total_acc, total_err, total_cer, n = 0.0, 0.0, 0.0, 0.0, 0
        logits = att = label = None
        for b_idx, b in enumerate(self.valid_ds.iter_batches(drop_last=False)):
            self.verbose(f"Validation step - ( {b_idx} / "
                         f"{self.valid_ds.num_batches(drop_last=False)} )", progress=True)
            x, x_lens, y = self._placed(b)
            ans_len = y.shape[1] - 1
            _, lg, at = las.asr_forward(self.model, x, x_lens, ans_len + 30)
            per_utt = losses.masked_nll_per_utt(lg[:, :ans_len], y[:, 1:], y).cpu().numpy()
            logits, att = lg.cpu().numpy(), at.cpu().numpy()
            label = b.y[:, 1:]
            valid = b.valid if b.valid is not None else np.ones(b.y.shape[0], bool)
            n_b = int(valid.sum())
            total_loss += float(per_utt[valid].sum())
            lv = logits[valid]
            total_acc += calc_acc(lv[:, : label.shape[1]], label[valid]) * n_b
            total_err += calc_err(lv, label[valid], mapper=self.mapper) * n_b
            total_cer += calc_cer(lv, label[valid], mapper=self.mapper) * n_b
            n += n_b

        avg_loss = total_loss / max(n, 1)
        self.lg.scalar("eval_loss", avg_loss, self.tr.step)
        self.lg.scalar("eval_error", total_err / max(n, 1), self.tr.step)
        self.lg.scalar("eval_acc", total_acc / max(n, 1), self.tr.step)
        self.lg.scalar("eval_cer", total_cer / max(n, 1), self.tr.step)

        # attention maps + hypotheses for the last batch
        if logits is not None:
            hyp_ids = np.argmax(logits, axis=-1)
            val_hyp = [self.mapper.translate(p) for p in hyp_ids]
            val_txt = [self.mapper.translate(t) for t in label]
            for idx, attmap in enumerate(draw_att(att, hyp_ids)[:4]):
                self.lg.image(f"eval_att_{idx}", attmap, self.tr.step)
                self.lg.text(f"eval_hyp_{idx}",
                             f"{val_hyp[idx]} |predict vs. real| {val_txt[idx]}", self.tr.step)

        if self.improved(avg_loss):
            self.tr.set_best(avg_loss)
            self.verbose(f"Best validation loss for ASR : {avg_loss:.4f} @ global step "
                         f"{self.tr.step}")
            self.save_tree(self.best_ckppath, self.params_tree())
            if logits is not None and self.is_writer:
                with open(os.path.join(self.ckpdir, "best_hyp.txt"), "w") as f:
                    for t1, t2 in zip(val_hyp, val_txt):
                        f.write(f"{t1},{t2}\n")
        else:
            self.verbose(f"Validation metric worse : ({avg_loss:.4f} vs. "
                         f"{self.tr.get_best():.4f})")

    def close(self):
        self.verbose(f"Finished training! Saving most recent model at step {self.tr.step}")
        self.save_state()
        self.lg.close()
