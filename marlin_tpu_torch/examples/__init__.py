"""The port's example CLIs: the user entry points of ``examples/``, run as
``python -m marlin_tpu_torch.examples.<name> ...`` (see :mod:`._common`)."""
