"""ASVspoof train-protocol parser (the port's own copy of
`occm_tpu.io.protocols.parse_train_protocol`).

Protocol line example (LA train):
    LA_0079 LA_T_1138215 - - bonafide
The meta-batch dataset uses the label strings as they are ('bonafide' /
'spoof'); its integer convention is spoof=1 / bonafide=0.
"""

from __future__ import annotations

from typing import List, Tuple


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
