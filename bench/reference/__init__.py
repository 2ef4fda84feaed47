"""The plain reference of the benchmark's models: float32 PyTorch with
TF32 off, no kernels, no cache, no batching. It imports neither JAX, the
JAX package nor anything of the port, and takes only the configuration's
`model` dict, the weights the benchmark made and the inputs it drew.

Each model family has a module of its own, `bench/reference/<family>.py`
(the configuration's `family`), with the same functions: `layer_specs`,
`loss`, `logits_at`, `exact_fp32` and `to_f32`. A configuration of a new
family adds its module beside the others."""
import importlib


def for_model(model: dict):
    """The reference module of the model's family."""
    return importlib.import_module(f"{__name__}.{model['family']}")
