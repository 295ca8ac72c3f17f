"""The port's inference command lines: ``gen-samples``, ``gen-videos`` and
``reenact`` (``python -m next3d_tpu_torch.cli.main <command> --help``)."""
