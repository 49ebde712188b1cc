"""Carry operands across from numpy (and so from the JAX package).

The JAX package hands its arrays over as numpy arrays
(``np.asarray(jax_array)``). A bf16 array then carries the ``ml_dtypes``
bfloat16 dtype, which ``torch.from_numpy`` rejects: it goes through its
uint16 bit pattern instead, so the tensor is the array bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """The torch dtype for a dtype name as the CSVs and CLIs spell it."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _TORCH_DTYPES[str(name)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r}; supported: {sorted(_TORCH_DTYPES)}"
        ) from None


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the spelling the CSVs record."""
    return str(dtype).removeprefix("torch.")


def from_numpy(arr, device: torch.device | str) -> torch.Tensor:
    """A tensor on ``device`` holding exactly ``arr``'s values (bf16 bit for
    bit through its uint16 view)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. np.asarray(jax_array); tensors may be written
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def place_operands(strategy, mesh, a_np, x_np):
    """The port's placed operands for ``strategy`` on ``mesh`` from numpy
    arrays — what ``jax.device_put(a, NamedSharding(...))`` is to the JAX
    package."""
    return strategy.place(from_numpy(a_np, "cpu"), from_numpy(x_np, "cpu"), mesh)
