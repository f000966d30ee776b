"""PyTorch/CUDA port of idc_models_tpu for an NVIDIA H100.

The JAX package `idc_models_tpu` is the reference; this package mirrors
its module names (data/, models/, ops/, train/, federated/, secure/,
observe/, cli.py) so each module's counterpart is easy to find, and never
imports it or `jax`.

Layouts at the public functions are the JAX package's: NHWC activations,
HWIO conv kernels, [kh, kw, 1, C] depthwise kernels, [in, out] dense
kernels. State-dict keys are the JAX tree paths with "/" spelled "." —
`convert.py` carries weights across in both directions.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (`resolve_device`).
"""

from __future__ import annotations


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise.

    ``None`` means ``"cuda"``. A CUDA request on a machine without a card
    raises instead of quietly running on the CPU. (torch is imported
    here, not with the package: the data loader's decode workers import
    the package and need only numpy.)"""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "(--device cpu) to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
