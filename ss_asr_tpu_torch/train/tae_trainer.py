"""Text-autoencoder training that also updates the shared ASR subtrees.

Port of ``ss_asr_tpu/train/tae_trainer.py``.  One optimizer
spans the whole TAE plus the ASR's embed / attention / decoder / char_trans
(``SHARED_ASR_SUBTREES``); the listener is in the parameter set (its
gradient, which is zero, passes the NaN check) and never moves.  Both the TAE
and the mutated ASR are checkpointed (``tae.npz``, the ASR relay, and
``tae_opt.npz`` in the JAX package's layout).

Quirk preserved: the loss compares decode step t's logits with ``y[t]``
(unshifted, unlike the ASR trainer's ``y[t + 1]``); position 0 is pad.

Data parallel as ``ASRTrainer`` (``Solver``): a rank's shard of the
index, the targets padded to the longest over the ranks, the global
batch's draws, one all-reduce of the gradients and the loss.

On the card the text encoder runs kernels K2 / K3 and the decode K9 / K10
over a memory of S = noised-text length.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.models import text_autoencoder as tae_mod
from ss_asr_tpu_torch.train import losses
from ss_asr_tpu_torch.train.optim import prefix_mask
from ss_asr_tpu_torch.train.solver import Solver, joint_named_parameters, make_optim

#: ASR subtrees the TAE trainer updates
SHARED_ASR_SUBTREES = (("asr", "embed"), ("asr", "attention"), ("asr", "decoder"),
                       ("asr", "char_trans"))
TRAINED = (("tae",),) + SHARED_ASR_SUBTREES


class TAETrainer(Solver):
    def __init__(self, config, paras, device: str = "cuda"):
        super().__init__(config, paras, "tae", device)

    def load_data(self):
        c = self.config["tae"]
        lb = c.get("l_bucket", 16)
        self.train_ds = ASRDataset(c["train_index"], batch_size=self.train_batch_size,
                                   text_only=True, drop_rate=c["drop_rate"], l_bucket=lb,
                                   host_shard=self.host_shard)
        self.valid_ds = ASRDataset(c["valid_index"], batch_size=self.valid_batch_size,
                                   text_only=True, drop_rate=c["drop_rate"], l_bucket=lb)
        self.mapper = self.train_ds.mapper

    def set_model(self, asrpath=None):
        self.asrpath_in, self.asrpath_out = self.genpath(asrpath, "asr")
        self.asr_cfg = las.ASRConfig.from_dict(self.config["asr"]["mdl"])
        self.tae_cfg = tae_mod.TAEConfig.from_dict(self.config["tae"]["mdl"])
        asr = self.load_module("asr", las.LAS(self.asr_cfg),
                               lambda seed: convert.init_asr_numpy(seed, self.asr_cfg),
                               self.asrpath_in)
        tae = self.load_module("tae", tae_mod.TextAutoencoder(self.tae_cfg),
                               lambda seed: convert.init_tae_numpy(seed, self.tae_cfg),
                               self.ckppath)
        self.models = {"asr": asr, "tae": tae}
        c = self.config["tae"]["opt"]
        named = joint_named_parameters(self.models)
        self.optim = make_optim(named, c, mask=prefix_mask([n for n, _ in named], TRAINED))
        self.restore_opt(self.optim, self.opt_ckppath, TRAINED)
        self.broadcast_state(self.models.values(), [self.optim])

    def _placed(self, b):
        return tuple(torch.from_numpy(a).to(self.device).long()
                     for a in (b.y, b.y_noised, b.y_noised_lens))

    def loss_of(self, y, y_noised, noise_lens, tf_draws=None, gumbel=None):
        """(loss, logits [B, L, V]) of one batch; L = y's width.  Without
        draws they come from the solver's generator at the ASR's tf_rate."""
        L = y.shape[1]
        if tf_draws is None:
            tf_draws, gumbel = las.draw_scheduled_sampling(
                L, y.shape[0], self.asr_cfg.tf_rate, self.asr_cfg, self.generator,
                device=self.device)
        teacher = F.pad(y, (0, 1))  # a pad column so that teacher[t + 1] exists
        _, logits = tae_mod.tae_forward(self.models["asr"], self.models["tae"], teacher, y_noised,
                                        noise_lens, L, tf_draws, gumbel)
        return losses.masked_ce_per_utt(logits, y, y), logits

    def step(self, y, y_noised, noise_lens, tf_draws=None, gumbel=None):
        """One update on a batch already on the device -> (loss, logits),
        detached.  Without draws they are the global batch's (``Solver``)."""
        L_own = y.shape[1]
        if tf_draws is None:
            L = self.global_width(L_own)
            if L > L_own:  # pad columns: masked out of the loss
                y = F.pad(y, (0, L - L_own))
            Bg, rows = self.global_rows(y.shape[0])
            tf_draws, gumbel = las.draw_scheduled_sampling(
                L, Bg, self.asr_cfg.tf_rate, self.asr_cfg, self.generator, device=self.device)
            if rows is not None:
                gumbel = gumbel[:, rows].contiguous()
        self.zero_grad()
        loss, logits = self.loss_of(y, y_noised, noise_lens, tf_draws, gumbel)
        loss.backward()
        (loss,) = self.dp_average(self.optim.params.values(), loss.detach())
        self.optim.step()
        return loss.detach(), logits.detach()[:, :L_own]

    def exec(self):
        self.verbose(f"Training set total {len(self.train_ds)} batches")
        for epoch in range(self.n_epochs):
            self.verbose(f"Starting epoch {epoch + 1} out of {self.n_epochs}")
            self.train_ds.set_epoch(epoch)
            n_steps = self.global_min_batches(len(self.train_ds))
            for b_ind, b in enumerate(self.train_ds.iter_batches()):
                if b_ind >= n_steps:
                    break
                self.verbose(f"Batch: {b_ind}/{len(self.train_ds)}, global step: {self.tr.step}",
                             progress=True)
                loss, _ = self.step(*self._placed(b))
                if self.tr.step % self.logging_step == 0:
                    self.lg.scalar("train_loss", float(loss), self.tr.step)
                if self.tr.step % self.valid_step == 0:
                    self.valid()
                if self.tr.step % self.save_step == 0:
                    self.verbose(f"Model saved at step {self.tr.step}")
                    self.save_all()
                self.tr.do_step()

    @torch.no_grad()
    def valid(self):
        avg_loss, n = 0.0, 0
        logits = b = None
        for b_idx, b in enumerate(self.valid_ds.iter_batches(drop_last=False)):
            self.verbose(f"Validation step -( {b_idx} / "
                         f"{self.valid_ds.num_batches(drop_last=False)} )", progress=True)
            loss, logits = self.loss_of(*self._placed(b))
            avg_loss += float(loss)
            n += 1
        avg_loss /= max(n, 1)

        if logits is not None:
            labels = [self.mapper.translate(t) for t in b.y]
            predicts = [self.mapper.translate(p) for p in np.argmax(logits.cpu().numpy(), axis=-1)]
            for i in range(min(4, len(labels))):
                self.lg.text(f"eval_text{i}", f"{labels[i]} |vs.| {predicts[i]}", self.tr.step)

        self.lg.scalar("eval_loss", avg_loss, self.tr.step)
        if self.improved(avg_loss):
            self.tr.set_best(avg_loss)
            self.verbose(f"Best validation loss : {avg_loss:.4f} @ global step {self.tr.step}")
            self.save_tree(self.best_ckppath, self.tree("tae"))
        else:
            self.verbose(f"Validation metric worse : ({avg_loss:.4f} vs. "
                         f"{self.tr.get_best():.4f})")

    def save_all(self):
        self.save_tree(self.ckppath, self.tree("tae"))
        self.save_tree(self.asrpath_out, self.tree("asr"))
        self.save_opt(self.opt_ckppath, convert.opt_state_leaves(self.optim, self.models, TRAINED))

    def close(self):
        self.verbose(f"Finished training! Saving most recent model at step {self.tr.step} "
                     "plus the ASR")
        self.save_all()
        self.lg.close()
