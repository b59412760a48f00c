"""`occm-export-model` of the port: an orbax directory of the JAX package
(a trainer epoch directory, a converter's save, a bare parameter tree) ->
a torch .pt state dict in the reference's naming
(`models.convert_backend`).

    python -m occm_tpu_torch.cli.export_model ckpt_dir out.pt \
        [--kind auto|amodel|senet|lcnn|ssl_resnet34] [--tiny]
"""

from occm_tpu_torch.models.convert_backend import main_export as main

if __name__ == "__main__":
    main()
