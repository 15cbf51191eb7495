"""Host data: the datamodule registry (JAX `data/__init__.py`) and its
input pipelines, numpy batches in NHWC (paired tasks: ``{'x', 'y'}``)."""

from .. import registry

register_datamodule = registry.datamodules.register
get_datamodule = registry.datamodules.get


def create_datamodule(config):
    """The recipe's ``data.datamodule``, built from the config (JAX
    `data/__init__.py:create_datamodule`)."""
    return get_datamodule(config.data.datamodule)(config)


from . import image_folder  # noqa: E402,F401
from . import paired  # noqa: E402,F401
from . import pkl_datasets  # noqa: E402,F401
from . import sr_multiscale  # noqa: E402,F401
from . import synthetic  # noqa: E402,F401

__all__ = ["register_datamodule", "get_datamodule", "create_datamodule"]
