"""Map-style datasets over ASVspoof protocol trees (port of
`occm_tpu.data.datasets.PFDataset` and `ASVDataset`).

- PFDataset: each item is a 12-utterance meta-batch ([12, cut] float32,
  labels [12]). The default pads every utterance to a fixed `cut` by
  repeating it (`pad_mode="repeat"`); `pad_mode="group_max"` zero-pads to
  the group's longest utterance, the reference's layout. The random picks
  inside a meta-batch come from a per-index
  `np.random.default_rng((seed, idx))`, so they depend only on (seed, idx)
  and match the JAX package's.
- ASVDataset (reference: oc_classifier.py:27-110), the scoring dataset:
  bonafide-only rows of a train protocol, or a bare eval list; items are
  full-length waves (the scorer buckets them).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from occm_tpu_torch.audio.frontend import pad, zero_pad_to_max
from occm_tpu_torch.data.sampler import PFSampler
from occm_tpu_torch.io.protocols import (
    parse_eval_protocol, parse_train_protocol)
from occm_tpu_torch.io.wav import load_audio

AudioLoader = Callable[[str], Tuple[np.ndarray, int]]


def _default_loader(path: str) -> Tuple[np.ndarray, int]:
    return load_audio(path, sr=None)  # WAV or FLAC, by magic bytes


def _resolve(base_dir: str, name: str, exts=(".wav", ".flac")) -> str:
    """The first of name.wav, name.flac that exists (reference:
    oc_classifier.py:89-91)."""
    for ext in exts:
        p = os.path.join(base_dir, name + ext)
        if os.path.exists(p):
            return p
    return os.path.join(base_dir, name + exts[0])


class PFDataset:
    """One-class meta-batch dataset (reference: oc_training.py:31-256)."""

    def __init__(
        self,
        protocol_file: str,
        dataset_dir: str,
        vocoded_dir: Optional[str] = None,
        cut: int = 64600,
        pad_mode: str = "repeat",           # "repeat" | "group_max"
        loader: AudioLoader = _default_loader,
        seed: int = 0,
    ):
        if pad_mode not in ("repeat", "group_max"):
            raise ValueError(f"unknown pad_mode {pad_mode!r} "
                             "(repeat | group_max)")
        files, labels = parse_train_protocol(protocol_file)
        self.sampler = PFSampler(files, labels)
        self.dataset_dir = dataset_dir
        # reference hard-codes the vocoded dir (oc_training.py:72)
        self.vocoded_dir = vocoded_dir or os.path.join(
            os.path.dirname(dataset_dir.rstrip("/")), "ASVspoof2019_LA_vocoded"
        )
        self.cut = cut
        self.pad_mode = pad_mode
        self.loader = loader
        self._seed = seed

    def __len__(self) -> int:
        return len(self.sampler)

    def reseed(self, seed: int) -> None:
        self._seed = seed

    def _rng_for(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self._seed, idx))

    def sample_paths(self, idx: int) -> Tuple[List[str], np.ndarray]:
        """The 12 file paths and labels of meta-batch `idx`, undecoded."""
        main, vocoded, labels = self.sampler.sample(idx, self._rng_for(idx))
        paths = [_resolve(self.dataset_dir, n) for n in main]
        paths += [_resolve(self.vocoded_dir, n) for n in vocoded]
        return paths, np.asarray(labels, np.int64)

    def supports_native_batch(self) -> bool:
        """The native threaded reader is not wired into the port yet
        (ROADMAP queue A): every meta-batch decodes in Python."""
        return False

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(features [12, T], labels [12]) with T = cut (repeat mode) or
        the group max (group_max mode)."""
        paths, labels = self.sample_paths(idx)
        waves = [self.loader(p)[0] for p in paths]
        if self.pad_mode == "group_max":
            feats = zero_pad_to_max(waves)
        else:
            feats = np.stack([pad(w, self.cut) for w in waves])
        return feats.astype(np.float32), labels


class ASVDataset:
    """Scoring dataset (reference: oc_classifier.py:27-110).

    eval=False: bonafide protocol rows only (reference: oc_classifier.py:69-78)
    eval=True:  bare-utterance list (reference: oc_classifier.py:58-67)
    """

    def __init__(
        self,
        protocol_file: str,
        dataset_dir: str,
        eval: bool = False,  # noqa: A002 - mirrors the reference kwarg
        loader: AudioLoader = _default_loader,
    ):
        self.dataset_dir = dataset_dir
        self.eval = eval
        self.loader = loader
        if eval:
            self.file_list = parse_eval_protocol(protocol_file)
            self.label_list = ["unknown"] * len(self.file_list)
        else:
            files, labels = parse_train_protocol(protocol_file)
            self.file_list = [
                f for f, l in zip(files, labels) if l == "bonafide"
            ]
            self.label_list = ["bonafide"] * len(self.file_list)

    def __len__(self) -> int:
        return len(self.file_list)

    def file_paths(self) -> Optional[List[str]]:
        """Resolved audio paths in dataset order, for
        `BucketedEmbedder.embed_paths`; None when a custom loader is
        installed (its decode would be bypassed)."""
        if self.loader is not _default_loader:
            return None
        return [
            _resolve(self.dataset_dir, name, exts=(".flac", ".wav"))
            for name in self.file_list
        ]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        path = _resolve(self.dataset_dir, self.file_list[idx],
                        exts=(".flac", ".wav"))
        wave, _ = self.loader(path)
        label = 1 if self.label_list[idx] == "spoof" else 0
        return wave.astype(np.float32), label
