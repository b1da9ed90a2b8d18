"""The semi-supervised Seed pipeline: configurable stage chains.

Port of ``ss_asr_tpu/train/seed.py``.  Each super-iteration runs the stages
of ``seed_train.stages`` (default TAE -> ADV -> SAE); each stage loads the
previous stage's mutated ASR checkpoint and writes its own (``asr_1.npz`` ->
``asr_2.npz`` -> ``asr_3.npz``: the TAE mutates ``asr_1`` in place, every
later stage reads the previous relay and writes the next), after which an
``ASRTrainer`` run fine-tunes the seeded ASR.  The files are the JAX
package's, so a chain started by one package continues in the other.

    +TAE            stages: [tae]
    +TAE+ADV        stages: [tae, adv]
    +TAE+ADV+SAE    stages: [tae, adv, sae]   (the default)
    +TAE+SAE        stages: [tae, sae]
    +TAE+SAE+ADV    stages: [tae, sae, adv]

``seed_train.its`` and ``seed_train.super_its`` both set the number of
super-iterations.
"""

from __future__ import annotations

import os

from ss_asr_tpu_torch.train.adv_trainer import ADVTrainer
from ss_asr_tpu_torch.train.sae_trainer import SAETrainer
from ss_asr_tpu_torch.train.tae_trainer import TAETrainer

_STAGES = ("tae", "adv", "sae")


def asr_seed_train(config, paras, device: str = "cuda"):
    ckpdir = os.path.join(paras.ckpdir, paras.name)
    seed_cfg = config.get("seed_train", {})
    its = seed_cfg.get("its", seed_cfg.get("super_its", 1))
    stages = [str(s).lower() for s in seed_cfg.get("stages", list(_STAGES))]
    unknown = [s for s in stages if s not in _STAGES]
    if unknown:
        raise ValueError(f"seed_train.stages: unknown stage(s) {unknown}; valid: {list(_STAGES)}")
    if "adv" in stages and "tae" not in stages[: stages.index("adv")]:
        raise ValueError("seed_train.stages: 'adv' needs a 'tae' stage earlier in the chain — the "
                         "discriminator's real data is the TAE text encoder's output")

    def relay(k):
        return os.path.join(ckpdir, f"asr_{k}.npz")

    for i in range(its):
        print(f"Starting Super Iteration {i + 1}")
        cur, nxt = 1, 2
        tae_path = None
        for stage in stages:
            print(f"Starting {stage.upper()} training")
            if stage == "tae":
                solver = TAETrainer(config, paras, device=device)
                solver.load_data()
                solver.set_model(asrpath=(relay(cur), relay(cur)))
                tae_path = solver.ckppath
            elif stage == "adv":
                solver = ADVTrainer(config, paras, device=device)
                solver.load_data()
                solver.set_model(taepath=tae_path, asrpath=(relay(cur), relay(nxt)))
                cur, nxt = nxt, nxt + 1
            else:  # sae
                solver = SAETrainer(config, paras, device=device)
                solver.load_data()
                solver.set_model(asrpath=(relay(cur), relay(nxt)))
                cur, nxt = nxt, nxt + 1
            solver.exec()
            solver.close()
            del solver
