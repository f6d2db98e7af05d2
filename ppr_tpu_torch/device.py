"""Where the port's tensors live.

The device is chosen once, when a graph is placed (``build_graph(...,
device=...)``), and every later tensor follows the graph's device. The
default, ``device=None``, is the card: with no CUDA device visible it
raises, and never carries on on the CPU. A caller that wants the CPU asks
for it (``device="cpu"``, or ``--device cpu`` on the CLI), as the tests do.
A function handed a CUDA tensor runs on the card or raises.
"""

from __future__ import annotations

import torch

NO_CARD = ("no CUDA device is visible: the port runs on the card by "
           "default; pass device=\"cpu\" (--device cpu on the CLI) to run "
           "on the CPU")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card. A CUDA
    device, the default included, raises ``RuntimeError`` when the process
    sees no card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    return device


#: the card (``resolve_device()``)
default_device = resolve_device


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU), so that a
    host clock read next covers it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_exact_f32_matmul() -> None:
    """Full-f32 products for the dense operators and the oracle.

    The JAX package runs them at ``Precision.HIGHEST``; TF32 keeps ~10
    mantissa bits and would lose ~1e-3 of mass per propagation pass
    (``ppr_tpu/ops/spmv.py:50-55``). These are PyTorch's defaults for
    matmuls; the port states and sets them rather than rely on them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
