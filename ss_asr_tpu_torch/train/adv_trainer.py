"""Adversarial (GAN-style) listener training.

Port of ``ss_asr_tpu/train/adv_trainer.py``.  D = a
per-timestep MLP discriminator, G = the ASR listener, "real" data = the text
autoencoder's ``TextEncoder`` output on transcripts.  Two steps per batch:

* D-step: ``BCE(D(text_enc(y)), 1 - label_smoothing) + BCE(D(listener(x)
  detached), 0)``, updating the discriminator only;
* G-step: ``BCE(D(listener(x)), 1)``, updating the listener only.

Two masked optimizers (``adv.D_opt``, ``adv.G_opt``) with separate
accumulators and NaN counters run over ONE parameter set {asr, tae, disc}:
each reads every gradient for its NaN check (in the D-step the frozen text
encoder's gradients are non-zero) and moves only its own subtree.  Their
states are ``adv_G_opt.npz`` / ``adv_D_opt.npz`` in the JAX package's layout.
Data parallel (``Solver``): a rank's shard of the index; the D-step and the
G-step each average their own gradients and losses over the ranks in one
all-reduce before their optimizer's step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset
from ss_asr_tpu_torch.models import discriminator as disc_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.models import text_autoencoder as tae_mod
from ss_asr_tpu_torch.train import losses
from ss_asr_tpu_torch.train.optim import prefix_mask
from ss_asr_tpu_torch.train.solver import Solver, joint_named_parameters, make_optim

G_TRAINED = (("asr", "encoder"),)
D_TRAINED = (("disc",),)


class ADVTrainer(Solver):
    def __init__(self, config, paras, device: str = "cuda"):
        super().__init__(config, paras, "adv", device)

    def load_data(self):
        c = self.config["adv"]
        tb, lb = c.get("t_bucket", 128), c.get("l_bucket", 16)
        self.train_ds = ASRDataset(c["train_index"], batch_size=self.train_batch_size,
                                   t_bucket=tb, l_bucket=lb, host_shard=self.host_shard)
        # the reference reads adv.eval_index, which its own config lacks: either key
        eval_index = c.get("eval_index", c.get("valid_index"))
        self.valid_ds = ASRDataset(eval_index, batch_size=self.valid_batch_size,
                                   t_bucket=tb, l_bucket=lb)
        self.mapper = self.train_ds.mapper

    def set_model(self, asrpath=None, taepath=None):
        self.refuse_tp()
        self.asrpath_in, self.asrpath_out = self.genpath(asrpath, "asr")
        taepath_in, _ = self.genpath(taepath, "tae")
        self.asr_cfg = las.ASRConfig.from_dict(self.config["asr"]["mdl"])
        self.tae_cfg = tae_mod.TAEConfig.from_dict(self.config["tae"]["mdl"])
        self.disc_cfg = disc_mod.DiscriminatorConfig.from_dict(
            {**self.config["adv"]["mdl"], "in_dim": self.asr_cfg.enc_out_dim})
        self.label_smoothing = self.config["adv"].get("label_smoothing", 0.1)
        self.models = {
            "asr": self.load_module("asr", las.LAS(self.asr_cfg),
                                    lambda seed: convert.init_asr_numpy(seed, self.asr_cfg),
                                    self.asrpath_in),
            "tae": self.load_module("tae", tae_mod.TextAutoencoder(self.tae_cfg),
                                    lambda seed: convert.init_tae_numpy(seed, self.tae_cfg),
                                    taepath_in),
            "disc": self.load_module("disc", disc_mod.Discriminator(self.disc_cfg),
                                     lambda seed: convert.init_disc_numpy(seed, self.disc_cfg),
                                     self.ckppath),
        }
        g, d = self.config["adv"]["G_opt"], self.config["adv"]["D_opt"]
        named = joint_named_parameters(self.models)
        names = [n for n, _ in named]
        self.G_optim = make_optim(named, g, mask=prefix_mask(names, G_TRAINED))
        self.D_optim = make_optim(named, d, mask=prefix_mask(names, D_TRAINED))
        self.g_opt_ckppath = os.path.join(self.ckpdir, "adv_G_opt.npz")
        self.d_opt_ckppath = os.path.join(self.ckpdir, "adv_D_opt.npz")
        # loaded_ckpt: the discriminator's own checkpoint was found
        self.restore_opt(self.G_optim, self.g_opt_ckppath, G_TRAINED)
        self.restore_opt(self.D_optim, self.d_opt_ckppath, D_TRAINED)
        self.broadcast_state(self.models.values(), [self.G_optim, self.D_optim])

    def _placed(self, b):
        return (torch.from_numpy(b.x).to(self.device), torch.from_numpy(b.x_lens).to(self.device),
                torch.from_numpy(b.y).to(self.device).long(),
                torch.from_numpy(b.y_lens).to(self.device))

    def d_losses(self, x, x_lens, y, y_lens, smooth: float):
        """(real loss, fake loss, real [B, S, D], fake [B, T // 8, D]); the
        listener's output is detached: the D-step moves no listener weight."""
        real = tae_mod.text_encode(self.models["tae"].encoder, y, y_lens)
        d_real = disc_mod.discriminate(self.models["disc"], real)
        real_loss = losses.bce(d_real, torch.full_like(d_real, 1.0 - smooth))
        with torch.no_grad():
            fake = las.listener_apply(self.models["asr"].encoder, x, x_lens)[0]
        d_fake = disc_mod.discriminate(self.models["disc"], fake)
        fake_loss = losses.bce(d_fake, torch.zeros_like(d_fake))
        return real_loss, fake_loss, real, fake

    def g_loss(self, x, x_lens):
        fake, _ = las.listener_apply(self.models["asr"].encoder, x, x_lens)
        d_out = disc_mod.discriminate(self.models["disc"], fake)
        return losses.bce(d_out, torch.ones_like(d_out))

    def d_step(self, x, x_lens, y, y_lens):
        """One discriminator update -> (real loss, fake loss), detached."""
        self.zero_grad()
        rl, fl, _, _ = self.d_losses(x, x_lens, y, y_lens, self.label_smoothing)
        (rl + fl).backward()
        rl, fl = self.dp_average(self.D_optim.params.values(), rl.detach(), fl.detach())
        self.D_optim.step()
        return rl.detach(), fl.detach()

    def g_step(self, x, x_lens):
        """One listener update -> the generator loss, detached."""
        self.zero_grad()
        loss = self.g_loss(x, x_lens)
        loss.backward()
        (loss,) = self.dp_average(self.G_optim.params.values(), loss.detach())
        self.G_optim.step()
        return loss.detach()

    def exec(self):
        self.verbose(f"Training set total {len(self.train_ds)} batches")
        for epoch in range(self.n_epochs):
            self.verbose(f"Starting epoch {epoch + 1} out of {self.n_epochs}")
            self.train_ds.set_epoch(epoch)
            n_steps = self.global_min_batches(len(self.train_ds))
            for b_idx, b in enumerate(self.train_ds.iter_batches()):
                if b_idx >= n_steps:
                    break
                self.verbose(f"Global step - {self.tr.step} ( {b_idx} / {len(self.train_ds)} )",
                             progress=True)
                x, xl, y, yl = self._placed(b)
                rl, fl = self.d_step(x, xl, y, yl)
                gl = self.g_step(x, xl)
                if self.tr.step % self.logging_step == 0:
                    self.lg.scalar("discrim_real_loss_train", float(rl), self.tr.step)
                    self.lg.scalar("discrim_fake_loss_train", float(fl), self.tr.step)
                    self.lg.scalar("discrim_loss_train", float(rl) + float(fl), self.tr.step)
                    self.lg.scalar("gen_loss_train", float(gl), self.tr.step)
                if self.tr.step % self.valid_step == 0:
                    self.valid()
                if self.tr.step % self.save_step == 0:
                    self.verbose(f"Model saved at step {self.tr.step}")
                    self.save_all()
                self.tr.do_step()

    @torch.no_grad()
    def valid(self):
        avg_real, avg_fake, n = 0.0, 0.0, 0
        real = fake = None
        for b_idx, b in enumerate(self.valid_ds.iter_batches(drop_last=False)):
            self.verbose(f"Validation step - {self.tr.step} ( {b_idx} / "
                         f"{self.valid_ds.num_batches(drop_last=False)} )", progress=True)
            rl, fl, real, fake = self.d_losses(*self._placed(b), 0.0)
            avg_real += float(rl)
            avg_fake += float(fl)
            n += 1
        avg_real /= max(n, 1)
        avg_fake /= max(n, 1)

        if real is not None:
            # every per-timestep embedding of the last validation batch, real and fake
            r, f = real.cpu().numpy(), fake.cpu().numpy()
            embs = np.concatenate([r.reshape(-1, r.shape[-1]), f.reshape(-1, f.shape[-1])])
            meta = ["real"] * (r.shape[0] * r.shape[1]) + ["fake"] * (f.shape[0] * f.shape[1])
            self.lg.embedding("validation_emb", embs, meta, self.tr.step)

        avg_loss = avg_real + avg_fake
        self.lg.scalar("discrim_real_loss_eval", avg_real, self.tr.step)
        self.lg.scalar("discrim_fake_loss_eval", avg_fake, self.tr.step)
        self.lg.scalar("discrim_loss_eval", avg_loss, self.tr.step)
        if self.improved(avg_loss):
            self.tr.set_best(avg_loss)
            self.verbose(f"Best validation loss : {avg_loss:.4f} @ global step {self.tr.step}")
            self.save_tree(self.best_ckppath, self.tree("disc"))

    def save_all(self):
        self.save_tree(self.ckppath, self.tree("disc"))
        self.save_tree(self.asrpath_out, self.tree("asr"))
        self.save_opt(self.g_opt_ckppath,
                      convert.opt_state_leaves(self.G_optim, self.models, G_TRAINED))
        self.save_opt(self.d_opt_ckppath,
                      convert.opt_state_leaves(self.D_optim, self.models, D_TRAINED))

    def close(self):
        self.verbose(f"Finished training! Saving most recent model at step {self.tr.step} "
                     "plus the ASR")
        self.save_all()
        self.lg.close()
