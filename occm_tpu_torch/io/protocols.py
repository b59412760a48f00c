"""ASVspoof protocol / metadata parsers (the port's own copy of
`occm_tpu.io.protocols`).

The reference parses protocol files with two opposite label conventions;
both are kept:

- `gen_spoof_list` (reference: data_utils_SSL.py:17-43): 5-column train
  protocol, label map **bonafide=1 / spoof=0**; eval mode returns the bare
  stripped line per row.
- `parse_train_protocol` (reference: oc_training.py:59-70): columns 2 and 5;
  the meta-batch dataset uses the label strings as they are, and its
  integer convention is **spoof=1 / bonafide=0**.
- trial-metadata parsing (reference: evaluate.py:7-68): column 2 = utt,
  column 6 = label.

Protocol line example (LA train):
    LA_0079 LA_T_1138215 - - bonafide
Metadata line example (DF eval):
    LA_0043 DF_E_2000026 mp3m4a asvspoof A09 spoof notrim eval traditional_vocoder - - - -
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def parse_train_protocol(path: str) -> Tuple[List[str], List[str]]:
    """Return (file_list, label_list) from columns 2 and 5: split on a
    single space, take line[1] and line[4], labels kept as raw strings."""
    file_list: List[str] = []
    label_list: List[str] = []
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split(" ")
            file_list.append(parts[1])
            label_list.append(parts[4])
    return file_list, label_list


def parse_eval_protocol(path: str) -> List[str]:
    """Bare-utterance-list protocol: one stripped token per line.

    Mirrors ASVDataset eval mode (reference: oc_classifier.py:58-67, which
    takes split(" ")[0]) and load_proto_file (reference: evaluate.py:70-83).
    """
    file_list: List[str] = []
    with open(path, "r") as f:
        for line in f:
            file_list.append(line.strip().split(" ")[0])
    return file_list


def gen_spoof_list(
    dir_meta: str, is_train: bool = False, is_eval: bool = False
):
    """Reference-compatible genSpoof_list (reference: data_utils_SSL.py:17-43).

    Train / default: returns (d_meta, file_list) where d_meta maps utt ->
    **1 for bonafide, 0 for spoof** (note: the opposite of the PFDataset
    convention).  Eval: returns the bare file list.
    """
    d_meta: Dict[str, int] = {}
    file_list: List[str] = []
    with open(dir_meta, "r") as f:
        lines = f.readlines()
    if is_eval:
        for line in lines:
            file_list.append(line.strip())
        return file_list
    for line in lines:
        _, key, _, _, label = line.strip().split()
        file_list.append(key)
        d_meta[key] = 1 if label == "bonafide" else 0
    return d_meta, file_list


def parse_metadata_labels(path: str) -> List[str]:
    """All labels from a trial_metadata file, column 6
    (reference: evaluate.py:7-22)."""
    labels: List[str] = []
    with open(path, "r") as f:
        for line in f:
            labels.append(line.strip().split(" ")[5])
    return labels


def parse_metadata_dict(path: str) -> Dict[str, str]:
    """utt -> label dict from a trial_metadata file
    (reference: evaluate.py:50-68)."""
    out: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split(" ")
            out[parts[1]] = parts[5]
    return out


def metadata_labels_for_protocol(meta_path: str, proto_path: str) -> List[str]:
    """Labels aligned to a bare-utterance protocol file
    (reference: evaluate.py:24-48).

    Rows of the protocol absent from the metadata keep an empty-string label,
    matching the reference's pre-initialised list.
    """
    protos = parse_eval_protocol(proto_path)
    index_of = {name: i for i, name in enumerate(protos)}
    labels = [""] * len(protos)
    with open(meta_path, "r") as f:
        for line in f:
            parts = line.strip().split(" ")
            idx = index_of.get(parts[1])
            if idx is not None:
                labels[idx] = parts[5]
    return labels
