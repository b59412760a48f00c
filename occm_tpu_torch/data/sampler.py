"""Meta-batch sampling for one-class training (the port's own copy of
`occm_tpu.data.sampler`).

Each bonafide anchor yields a 12-utterance meta-batch: [bona1..bona6,
spoof1] in sorted-key order, then 5 vocoded copies of bona1 (reference:
oc_training.py:129-256). Labels: bona=0, spoof/vocoded=1. Draws come from
an explicit numpy Generator, so the same draws give the same meta-batches
as the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# reference: oc_training.py:174
VOCODER_NAMES = (
    "hifigan",
    "hn-sinc-nsf-hifi",
    "hn-sinc-nsf",
    "melgan",
    "waveglow",
)


class PFSampler:
    """Draws the 6-bona + 1-spoof + 5-vocoded meta-batch file lists."""

    def __init__(self, file_list: Sequence[str], label_list: Sequence[str]):
        self.file_list = list(file_list)
        self.label_list = list(label_list)
        self.spoof_indices = [
            i for i, lab in enumerate(self.label_list) if lab == "spoof"
        ]
        self.bonafide_indices = [
            i for i, lab in enumerate(self.label_list) if lab == "bonafide"
        ]

    def __len__(self) -> int:
        # one meta-batch per bonafide utterance
        return len(self.bonafide_indices)

    def _random_files(self, rng: np.random.Generator,
                      indices: Sequence[int], exclude_idx, n: int
                      ) -> List[str]:
        """random.sample equivalent (reference: oc_training.py:129-150)."""
        pool = [i for i in indices if i != exclude_idx]
        if len(pool) < n:
            raise ValueError("Not enough files to select from.")
        chosen = rng.choice(len(pool), size=n, replace=False)
        return [self.file_list[pool[int(c)]] for c in chosen]

    def sample(self, idx: int, rng: np.random.Generator
               ) -> Tuple[List[str], List[str], List[int]]:
        """(main_files [bona1..bona6, spoof1], vocoded_names (5), labels
        (12)); idx indexes the bonafide list and picks the anchor bona1."""
        anchor = self.bonafide_indices[idx]
        bona = self._random_files(rng, self.bonafide_indices, anchor, 5)
        spoof = self._random_files(rng, self.spoof_indices, None, 1)
        main = [self.file_list[anchor]] + bona + spoof
        vocoded = [f"{v}_{self.file_list[anchor]}" for v in VOCODER_NAMES]
        labels = [0] * 6 + [1] + [1] * 5
        return main, vocoded, labels
