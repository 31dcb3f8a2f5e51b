"""Carry a parameter tree across from numpy: the bridge from the reference
package's weights to the port's, with no transposes (the layouts are the
same).

Leaves are numpy arrays, or any object with ``.q``/``.s`` (a quantized
weight and its scales — duck-typed, so nothing of the reference package
is imported). Shapes cannot tell the two precisions apart (an int4 leaf
with one scale group has ``s [..., 1, O]`` like an int8 one), so a leaf
whose type is named ``QTensor4`` becomes a :class:`~.quant.QTensor4` and
any other ``.q``/``.s`` leaf a :class:`~.quant.QTensor`. bf16 arrays
arrive as ``ml_dtypes.bfloat16``, which torch cannot read directly: they
cross as their raw 16-bit words
(``view(np.int16)`` -> ``torch.from_numpy`` -> ``view(torch.bfloat16)``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .quant import QTensor, QTensor4


def tensor_from_numpy(a, device: Optional[torch.device | str] = None
                      ) -> torch.Tensor:
    """One numpy array as a tensor on ``device`` (the card unless the
    CPU is asked for; see utils/device.py)."""
    device = resolve_device(device)
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:        # e.g. a view of a jax buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device: Optional[torch.device | str] = None):
    """The port's params on ``device`` (the card unless the CPU is asked
    for; see utils/device.py) from a numpy tree of the reference's layout
    (dicts of arrays and ``.q``/``.s`` leaves; 4-D expert leaves cross
    as they are)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "s"):
        kind = QTensor4 if type(tree).__name__ == "QTensor4" else QTensor
        return kind(q=tensor_from_numpy(tree.q, device),
                    s=tensor_from_numpy(tree.s, device))
    return tensor_from_numpy(tree, device)
