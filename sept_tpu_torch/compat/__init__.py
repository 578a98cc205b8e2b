"""Weights across packages: the JAX package's trees to the port's state_dicts
(``from_jax``), and the reference's ``model.pt`` in and out (``torch_io``)."""

from sept_tpu_torch.compat.torch_io import (
    export_backbone,
    export_cloak_noise,
    import_backbone,
    import_cloak_noise,
    load_torch_checkpoint,
    split_reference_state_dict,
)

__all__ = [
    "export_backbone",
    "export_cloak_noise",
    "import_backbone",
    "import_cloak_noise",
    "load_torch_checkpoint",
    "split_reference_state_dict",
]
