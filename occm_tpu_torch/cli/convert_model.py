"""`occm-convert-model` of the port: a reference-trained torch checkpoint
(aasist_vocoded_*.pt, senet34_vocoded_*.pt, ssl_vocoded_*.pt, LCNN, the
fused ssl_resnet34) -> an orbax directory of the JAX package's
{"params", "batch_stats"} (`models.convert_backend`).

    python -m occm_tpu_torch.cli.convert_model model.pt out_dir \
        [--kind auto|amodel|senet|lcnn|ssl|ssl_resnet34] [--tiny]
"""

from occm_tpu_torch.models.convert_backend import main

if __name__ == "__main__":
    main()
