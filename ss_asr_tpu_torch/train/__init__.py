"""Trainer registry with reference-CLI name parity.

Port of ``ss_asr_tpu/train/__init__.py``: the reference CLI advertises
``LMTrainer`` / ``AdvTrainer`` but defines ``CHARLMTrainer`` /
``ADVTrainer``; both spellings dispatch here.
"""

from ss_asr_tpu_torch.train.adv_trainer import ADVTrainer
from ss_asr_tpu_torch.train.asr_trainer import ASRTrainer
from ss_asr_tpu_torch.train.lm_trainer import CHARLMTrainer
from ss_asr_tpu_torch.train.sae_trainer import SAETrainer
from ss_asr_tpu_torch.train.seed import asr_seed_train
from ss_asr_tpu_torch.train.solver import Solver, make_paras
from ss_asr_tpu_torch.train.tae_trainer import TAETrainer
from ss_asr_tpu_torch.train.tester import ASRTester

TRAINERS = {
    "ASRTrainer": ASRTrainer,
    "ASRTester": ASRTester,
    "CHARLMTrainer": CHARLMTrainer,
    "LMTrainer": CHARLMTrainer,  # reference CLI spelling
    "TAETrainer": TAETrainer,
    "SAETrainer": SAETrainer,
    "ADVTrainer": ADVTrainer,
    "AdvTrainer": ADVTrainer,  # reference CLI spelling
}

__all__ = [
    "ADVTrainer",
    "ASRTester",
    "ASRTrainer",
    "CHARLMTrainer",
    "SAETrainer",
    "Solver",
    "TAETrainer",
    "TRAINERS",
    "asr_seed_train",
    "make_paras",
]
