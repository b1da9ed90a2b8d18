"""Speech-autoencoder training that also updates the ASR listener.

Port of ``ss_asr_tpu/train/sae_trainer.py``: smooth-L1
reconstruction of the input fbank from [listener frames | global conv
encoding]; the optimizer spans the SAE plus the ASR encoder (the speller is
in the parameter set and never moves).  The loss follows the reference's
pad-up / truncate-down alignment: it compares the first ``max(x_lens)``
frames (zeros beyond each sample's own length included).  The checkpoint is
``{"params", "bn_state"}``, as the JAX package writes it.

``sae.listener_lr_scale`` damps the listener's co-update (an update scale);
the listener-saturation telemetry (share of valid encoder activations with
|h| > 0.99) is logged at least once per epoch and warns once.

Data parallel (``Solver``): a rank's shard of the index, one all-reduce of
the gradients, the loss, the saturation and the batch norms' new running
statistics.  The batch norm normalises with the LOCAL batch's statistics
and only its new running statistics are averaged, as the JAX package's
``pmean(new_bn)`` does (not a synchronised batch norm).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.asr_dataset import ASRDataset
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.models import speech_autoencoder as sae_mod
from ss_asr_tpu_torch.train import losses
from ss_asr_tpu_torch.train.optim import prefix_mask
from ss_asr_tpu_torch.train.solver import Solver, joint_named_parameters, make_optim
from ss_asr_tpu_torch.utils import checkpoint as ckpt

TRAINED = (("sae",), ("asr", "encoder"))


class SAETrainer(Solver):
    def __init__(self, config, paras, device: str = "cuda"):
        super().__init__(config, paras, "sae", device)

    def load_data(self):
        c = self.config["sae"]
        tb, lb = c.get("t_bucket", 128), c.get("l_bucket", 16)
        self.train_ds = ASRDataset(c["train_index"], batch_size=self.train_batch_size,
                                   t_bucket=tb, l_bucket=lb, host_shard=self.host_shard)
        self.valid_ds = ASRDataset(c["valid_index"], batch_size=self.valid_batch_size,
                                   t_bucket=tb, l_bucket=lb)
        self.mapper = self.train_ds.mapper

    def set_model(self, asrpath=None):
        self.refuse_tp()
        self.asrpath_in, self.asrpath_out = self.genpath(asrpath, "asr")
        self.asr_cfg = las.ASRConfig.from_dict(self.config["asr"]["mdl"])
        self.sae_cfg = sae_mod.SAEConfig.from_dict({
            **self.config["sae"]["mdl"], "feature_dim": self.asr_cfg.feature_dim,
            "listener_out_dim": self.asr_cfg.enc_out_dim})
        asr = self.load_module("asr", las.LAS(self.asr_cfg),
                               lambda seed: convert.init_asr_numpy(seed, self.asr_cfg),
                               self.asrpath_in)
        sae = sae_mod.SpeechAutoencoder(self.sae_cfg)
        # the optimizer state's restore keys on the SAE's OWN checkpoint, not
        # on the ASR relay loaded above
        self.loaded_ckpt = ckpt.exists(self.ckppath)
        if self.loaded_ckpt:
            self.verbose(f"Loading a pretrained model from {self.ckppath}")
            loaded = ckpt.load_pytree(self.ckppath)
            params, bn_state = loaded["params"], loaded["bn_state"]
        else:
            self.verbose(f"No model found at {self.ckppath}. A new model will be created")
            params, bn_state = convert.init_sae_numpy(self.next_seed(), self.sae_cfg)
        sae.load_state_dict(convert.sae_state_from_params(params, bn_state))
        self.models = {"asr": asr, "sae": sae.to(self.device)}

        c = self.config["sae"]["opt"]
        named = joint_named_parameters(self.models)
        names = [n for n, _ in named]
        lr_scale = float(self.config["sae"].get("listener_lr_scale", 1.0))
        scales = [(prefix_mask(names, (("asr", "encoder"),)), lr_scale)] if lr_scale != 1.0 else None
        self.optim = make_optim(named, c, mask=prefix_mask(names, TRAINED), update_scales=scales)
        self.restore_opt(self.optim, self.opt_ckppath, TRAINED)
        self.broadcast_state(self.models.values(), [self.optim])

    def _placed(self, b):
        return (torch.from_numpy(b.x).to(self.device), torch.from_numpy(b.x_lens).to(self.device))

    def recon_loss(self, x, x_lens, train: bool):
        """(loss, recon [B, T, feat], listener saturation) of one batch."""
        listener_out, enc_lens = las.listener_apply(self.models["asr"].encoder, x, x_lens)
        recon = sae_mod.sae_forward(self.models["sae"], x, listener_out, train=train)
        T = x.shape[1]
        recon = recon[:, :T, :]
        if T > recon.shape[1]:  # the listener dropped odd frames (T not a multiple of 8)
            recon = F.pad(recon, (0, 0, 0, T - recon.shape[1]))
        t_valid = x_lens.max()
        with torch.no_grad():
            valid = (torch.arange(listener_out.shape[1], device=x.device)[None, :]
                     < enc_lens.clamp(min=1)[:, None])[..., None]
            sat = ((listener_out.abs() > 0.99) & valid).sum() / torch.clamp(
                valid.sum() * listener_out.shape[-1], min=1)
        return losses.masked_smooth_l1_mean(recon, x, t_valid), recon, sat

    def step(self, x, x_lens):
        """One update on a batch already on the device -> (loss, saturation)."""
        self.zero_grad()
        loss, _, sat = self.recon_loss(x, x_lens, True)
        loss.backward()
        if self.mesh is not None:
            stats = [b for b in self.models["sae"].buffers() if b.is_floating_point()]
            loss, sat, *new = self.dp_average(self.optim.params.values(), loss.detach(), sat,
                                              *stats)
            with torch.no_grad():
                for b, v in zip(stats, new):
                    b.copy_(v)
        self.optim.step()
        return loss.detach(), sat

    def exec(self):
        self.verbose(f"Training set total {len(self.train_ds)} batches.")
        # the saturation guard's cadence: a seed-pipeline stage runs far fewer
        # steps than a typical logging_step, so check at least once per epoch
        sat_every = max(min(self.logging_step, len(self.train_ds)), 1)
        for epoch in range(self.n_epochs):
            self.verbose(f"Starting epoch {epoch + 1} out of {self.n_epochs}")
            self.train_ds.set_epoch(epoch)
            n_steps = self.global_min_batches(len(self.train_ds))
            for b_ind, b in enumerate(self.train_ds.iter_batches()):
                if b_ind >= n_steps:
                    break
                self.verbose(f"Batch: {b_ind}/{len(self.train_ds)}, global step: {self.tr.step}",
                             progress=True)
                loss, sat = self.step(*self._placed(b))
                if self.tr.step % self.logging_step == 0:
                    self.lg.scalar("train_loss", float(loss), self.tr.step)
                if self.tr.step % sat_every == 0:
                    self.lg.scalar("listener_saturation", float(sat), self.tr.step)
                    self._check_saturation(float(sat))
                if self.tr.step % self.valid_step == 0:
                    self.valid()
                if self.tr.step % self.save_step == 0:
                    self.verbose(f"Model saved at step {self.tr.step}")
                    self.save_all()
                self.tr.do_step()

    def _check_saturation(self, sat: float) -> None:
        """Warn once when the co-updated listener saturates
        (``sae.saturation_warn``, default 0.005)."""
        threshold = float(self.config["sae"].get("saturation_warn", 0.005))
        if sat > threshold and not getattr(self, "saturation_warned", False):
            self.saturation_warned = True
            self.verbose(f"WARNING: listener saturation {sat:.4f} exceeds {threshold} — the SAE "
                         "co-update is pushing the shared listener into tanh saturation, which "
                         "poisons downstream ASR fine-tuning. Consider sae.listener_lr_scale < 1")

    def sae_tree(self):
        params, bn_state = convert.sae_params_from_state(self.models["sae"].state_dict())
        return {"params": params, "bn_state": bn_state}

    @torch.no_grad()
    def valid(self):
        avg_loss, avg_sat, n = 0.0, 0.0, 0
        recon = b = None
        for b_idx, b in enumerate(self.valid_ds.iter_batches(drop_last=False)):
            self.verbose(f"Validation step - {self.tr.step} ( {b_idx} / "
                         f"{self.valid_ds.num_batches(drop_last=False)} )", progress=True)
            loss, recon, sat = self.recon_loss(*self._placed(b), False)
            avg_loss += float(loss)
            avg_sat += float(sat)
            n += 1
        avg_loss /= max(n, 1)
        avg_sat /= max(n, 1)

        if recon is not None:  # spectrogram against reconstruction, the last batch
            r = recon.cpu().numpy()
            for i in range(min(2, r.shape[0])):
                ln = int(b.x_lens[i])
                self.lg.image(f"encode_compare_{i}", np.stack([b.x[i, :ln].T, r[i, :ln].T]),
                              self.tr.step)

        self.lg.scalar("eval_loss", avg_loss, self.tr.step)
        self.lg.scalar("eval_listener_saturation", avg_sat, self.tr.step)
        if self.improved(avg_loss):
            self.tr.set_best(avg_loss)
            self.verbose(f"Best validation loss : {avg_loss:.4f} @ global step {self.tr.step}")
            self.save_tree(self.best_ckppath, self.sae_tree())
        else:
            self.verbose(f"Validation metric worse : ({avg_loss:.4f} vs. "
                         f"{self.tr.get_best():.4f})")

    def save_all(self):
        self.save_tree(self.ckppath, self.sae_tree())
        self.save_tree(self.asrpath_out, self.tree("asr"))
        self.save_opt(self.opt_ckppath, convert.opt_state_leaves(self.optim, self.models, TRAINED))

    def close(self):
        self.verbose(f"Finished training! Saving most recent model at step {self.tr.step} "
                     "plus the ASR")
        self.save_all()
        self.lg.close()
