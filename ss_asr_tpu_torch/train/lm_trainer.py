"""Char-LM training.

Port of ``ss_asr_tpu/train/lm_trainer.py``.  A train step
unrolls the chunk with scheduled sampling (``charlm.teacher_forced_unroll``:
the input at step 0 is SOS, after step t the label where the step's
Bernoulli(``char_lm.mdl.tf_rate``) draw says so and the Gumbel-argmax sample
otherwise; the draws come from the solver's generator), takes
``losses.chunk_ce`` (summed over the chunk, meaned over the batch), the
backward, and clip + Adam under the NaN skip (``train/optim.py``).  The JAX
unroll is a ``lax.scan`` over ``gru_step`` with no Pallas kernel, and so is
this one a loop of ``rnn.gru_step`` under autograd: no hand-written kernel,
and no ``nn.GRU`` either, since scheduled sampling feeds each step's
sampled id back.

Data parallel (``Solver``): each rank reads its shard of the chunks
(``LMDataset(host_shard=)``, equal-sized shares), draws for the global
batch and keeps its rows, and averages the gradients and the loss over the
ranks before the optimizer's step.

Checkpoints are the JAX package's: ``char_lm.npz`` (the parameter tree),
``char_lm_opt.npz`` (the optax state's leaves), ``char_lm_best.npz`` and
``tracker.json``, so either package resumes from the other's files.
"""

from __future__ import annotations

import torch

from ss_asr_tpu_torch import convert
from ss_asr_tpu_torch.data.lm_dataset import LMDataset
from ss_asr_tpu_torch.models import charlm, las
from ss_asr_tpu_torch.train import losses
from ss_asr_tpu_torch.train.solver import Solver, joint_named_parameters, make_optim
from ss_asr_tpu_torch.vocab import SOS_TKN, Mapper


class CHARLMTrainer(Solver):
    def __init__(self, config, paras, device: str = "cuda"):
        super().__init__(config, paras, "char_lm", device)

    def load_data(self):
        c = self.config["char_lm"]
        self.chunk_size = c["chunk_size"]
        self.tf_rate = c["mdl"].get("tf_rate", 0.9)
        self.ds = LMDataset(c["train_index"], self.chunk_size, host_shard=self.host_shard)
        self.mapper = Mapper()

    def set_model(self):
        self.refuse_tp()
        c = self.config["char_lm"]
        self.cfg = charlm.CharLMConfig.from_dict({**c["mdl"], "tf_rate": self.tf_rate})
        lm = charlm.CharLM(self.cfg)
        tree = self.setup_params(convert.charlm_params_from_state(lm.state_dict()),
                                 lambda seed: convert.init_charlm_numpy(seed, self.cfg),
                                 self.ckppath)
        lm.load_state_dict(convert.charlm_state_from_params(tree))
        self.lm = lm.to(self.device)
        self.models = {"char_lm": self.lm}
        self.optim = make_optim(joint_named_parameters(self.models), c["opt"])
        self.restore_opt(self.optim, self.opt_ckppath, None)
        self.broadcast_state([self.lm], [self.optim])

    def params_tree(self):
        return convert.charlm_params_from_state(self.lm.state_dict())

    def save_state(self):
        super().save_state(self.params_tree(), convert.opt_state_leaves(self.optim, self.models))

    def draws(self, L: int, B: int, tf_rate: float):
        """One unroll's scheduled-sampling draws from the solver's generator:
        ``tf_draws [L]``, ``gumbel [L, B, V]``, on the device."""
        return las.draw_scheduled_sampling(L, B, tf_rate, self.cfg, self.generator,
                                           device=self.device)

    def loss_of(self, y: torch.Tensor, tf_draws=None, gumbel=None):
        """(loss, logits [B, L, V]) of a chunk batch y [B, L] on the device;
        without draws they come from the solver's generator at tf_rate."""
        if tf_draws is None:
            tf_draws, gumbel = self.draws(y.shape[1], y.shape[0], self.tf_rate)
        logits = charlm.teacher_forced_unroll(self.lm, y, tf_draws, gumbel)
        return losses.chunk_ce(logits, y), logits

    def step(self, y: torch.Tensor, tf_draws=None, gumbel=None):
        """One update on a chunk batch already on the device -> (loss,
        logits), both detached.  Without draws they are the global batch's
        (``Solver``)."""
        if tf_draws is None:
            Bg, rows = self.global_rows(y.shape[0])
            tf_draws, gumbel = self.draws(y.shape[1], Bg, self.tf_rate)
            if rows is not None:
                gumbel = gumbel[:, rows].contiguous()
        self.zero_grad()
        loss, logits = self.loss_of(y, tf_draws, gumbel)
        loss.backward()
        (loss,) = self.dp_average(self.optim.params.values(), loss.detach())
        self.optim.step()
        return loss.detach(), logits.detach()

    def exec(self):
        n_batches = len(self.ds) // self.train_batch_size
        self.verbose(f"Training set total {n_batches} batches.")
        if n_batches == 0:
            # an untrained LM at a fusion weight above 0 injects noise into
            # every decode that fuses it: say so rather than finish 0-step epochs
            self.verbose(
                "WARNING: 0 train batches — the corpus yields "
                f"{len(self.ds)} chunks of {self.ds.chunk_size} chars but "
                f"train_batch_size={self.train_batch_size}; the LM will be "
                "saved UNTRAINED. Shrink the batch or grow the corpus.")
        for epoch in range(self.n_epochs):
            self.verbose(f"Starting epoch {epoch + 1} out of {self.n_epochs}")
            self.ds.set_epoch(epoch)
            for b_ind, (_, y) in enumerate(
                    self.ds.iter_batches(self.train_batch_size, shuffle=True, seed=epoch)):
                self.verbose(f"Batch: {b_ind}/{n_batches}, global step: {self.tr.step}",
                             progress=True)
                loss, _ = self.step(torch.from_numpy(y).to(self.device).long())
                loss_by_char = float(loss) / self.chunk_size

                if self.tr.step % self.logging_step == 0:
                    self.lg.scalar("train_loss", loss_by_char, self.tr.step)

                if self.tr.step % self.valid_step == 0:
                    self.lg.text("text_generate", self.generate(), self.tr.step)
                    if loss_by_char < self.tr.get_best():
                        self.tr.set_best(loss_by_char)
                        self.save_tree(self.best_ckppath, self.params_tree())

                if self.tr.step % self.save_step == 0:
                    self.verbose(f"Model saved at step {self.tr.step}")
                    self.save_state()

                self.tr.do_step()
            self.verbose(f"Epoch {epoch} finished")

    def generate(self, length: int = 100, temp: float = 0.8, start: str = SOS_TKN) -> str:
        start_ids = torch.from_numpy(self.mapper.encode(start))
        out = charlm.generate(self.lm, self.cfg, self.generator, length, temp, start_ids)
        return start + self.mapper.decode(out.cpu().numpy())

    @torch.no_grad()
    def predict(self, x: str, y: str, tf_rate: float) -> float:
        """Teacher-forced probe: next-character accuracy (%) on a fixed
        sentence at the given tf rate.  As in the reference only the length
        of ``x`` matters: step 0 is fed SOS and the teacher character at
        step i is ``y[i]``."""
        y_ids = torch.from_numpy(self.mapper.encode(y))[None, :].to(self.device).long()
        tf_draws, gumbel = self.draws(y_ids.shape[1], 1, tf_rate)
        logits = charlm.teacher_forced_unroll(self.lm, y_ids, tf_draws, gumbel)
        pred_str = self.mapper.decode(torch.argmax(logits, dim=-1)[0].cpu().numpy())
        c = sum(int(pred_str[i] == y[i]) for i in range(len(pred_str)))
        acc = 100 * c / len(pred_str)
        self.verbose(f"{pred_str} {acc}")
        return acc

    def close(self):
        self.verbose(f"Finished training! Saving most recent model at step {self.tr.step}")
        self.save_state()
        self.lg.close()
