"""Host data: the datamodule registry (JAX `data/__init__.py`) and its
input pipelines, numpy batches in NHWC (paired tasks: ``{'x', 'y'}``)."""

from .. import registry

register_datamodule = registry.datamodules.register
get_datamodule = registry.datamodules.get

# JAX datamodules the port lacks, and the ROADMAP.md item that ports them
NOT_PORTED = {
    name: "ROADMAP.md section 1, item 12"
    for name in ("haar_multiscale", "bicubic_multiscale")
}


def create_datamodule(config):
    """The recipe's ``data.datamodule``, built from the config (JAX
    `data/__init__.py:create_datamodule`)."""
    name = config.data.datamodule
    if name in NOT_PORTED:
        raise NotImplementedError(f"datamodule {name!r} is not ported ({NOT_PORTED[name]})")
    return get_datamodule(name)(config)


from . import image_folder  # noqa: E402,F401
from . import paired  # noqa: E402,F401
from . import pkl_datasets  # noqa: E402,F401
from . import synthetic  # noqa: E402,F401

__all__ = ["register_datamodule", "get_datamodule", "create_datamodule"]
