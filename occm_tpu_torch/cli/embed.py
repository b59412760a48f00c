"""Dump model embeddings for downstream classifiers (port of
`occm_tpu.cli.embed`).

Checkpoint + protocol in, one `.npz` out with the JAX CLI's keys: `utts`,
`embeddings`, `logits` and `labels`. Labels follow the meta-batch dataset's
convention bonafide=0 / spoof=1 (reference: oc_training.py:225); eval-mode
(bare-utterance) protocols have no labels and get -1. The flags are the
JAX CLI's, plus --device; --pretrained-sslaasist takes a torch state dict
in the reference's naming; --data_parallel raises NotImplementedError.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Dump embeddings + logits for every utterance in a "
                    "protocol to an .npz (keys: utts, embeddings, logits, "
                    "labels).")
    parser.add_argument("--protocol_file", type=str, required=True,
                        help="train-format (5-column) or, with --eval, "
                             "bare-utterance-list protocol")
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--out", type=str, default="embeddings.npz")
    parser.add_argument("--eval", action="store_true",
                        help="protocol is a bare utterance list (labels "
                             "are written as -1)")
    parser.add_argument("--pretrained-sslaasist", type=str,
                        dest="pretrained_sslaasist",
                        default="aasist_vocoded_1.pt",
                        help="torch state dict of the full AModel in the "
                             "reference's naming")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--bucket_step", type=int, default=16000)
    parser.add_argument(
        "--decode_threads", type=int, default=8,
        help="threads of the native decode lane (not ported yet: files "
             "decode in Python, the same waves)")
    parser.add_argument("--data_parallel", type=int, default=0, metavar="N",
                        help="not ported yet: embedding runs on one GPU")
    parser.add_argument("--xlsr_tiny", action="store_true")
    parser.add_argument(
        "--fast_numerics", action="store_true", default=False,
        help="bf16 norms + tanh GELU (see oc_classifier --fast_numerics)")
    parser.add_argument(
        "--attention_impl", type=str, default="auto",
        help='"auto" (default) picks the attention impl per length bucket '
             "(see oc_classifier --attention_impl); or pin one")
    parser.add_argument("--allow_random_init", action="store_true",
                        help="embed with seeded random weights if the "
                             "checkpoint is missing (testing only)")
    parser.add_argument("--device", type=str, default="cuda",
                        help='torch device: "cuda" (default) or "cpu"')
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    import numpy as np

    from occm_tpu_torch.classify import BucketedEmbedder, make_embed_fn_factory
    from occm_tpu_torch.cli.oc_server import build_model, xlsr_config
    from occm_tpu_torch.data.datasets import _resolve
    from occm_tpu_torch.io.protocols import (
        parse_eval_protocol, parse_train_protocol)
    from occm_tpu_torch.utils.device import resolve_device

    if args.data_parallel:
        raise NotImplementedError(
            "--data_parallel is not ported to occm_tpu_torch yet (ROADMAP "
            "queue A item 15)")
    device = resolve_device(args.device)
    xlsr_cfg = xlsr_config(args.xlsr_tiny, args.fast_numerics)
    model = build_model(xlsr_cfg, args.pretrained_sslaasist,
                        args.allow_random_init, device)
    embedder = BucketedEmbedder(
        embed_fn_factory=make_embed_fn_factory(
            model, args.attention_impl, xlsr_cfg.norm_dtype),
        bucket_step=args.bucket_step, batch_size=args.batch_size,
        device=device)

    if args.eval:
        utts = parse_eval_protocol(args.protocol_file)
        labels = np.full(len(utts), -1, np.int32)
    else:
        utts, label_strs = parse_train_protocol(args.protocol_file)
        # meta-batch label map bona=0/spoof=1 (reference: oc_training.py:225)
        labels = np.asarray(
            [0 if s == "bonafide" else 1 for s in label_strs], np.int32)

    paths = [_resolve(args.dataset_dir, u, exts=(".flac", ".wav"))
             for u in utts]
    embs, logits = embedder.embed_paths(
        paths,
        progress=(lambda n: print(f"embedded {n} ..."))
        if args.verbose else None)
    np.savez(args.out, utts=np.asarray(utts), embeddings=embs,
             logits=logits, labels=labels)
    print(f"wrote {len(utts)} embeddings ({embs.shape[1]}-d) to {args.out}")


if __name__ == "__main__":
    main()
