"""Gamma-normalize kernel K3: wrapper, plain version, launch count.

:func:`gamma_normalize` (``csrc/gamma_normalize.cu``) replaces
``blendjax/ops/image.py:_pallas_gamma_normalize``: uint8 NHWC frames ->
``(x * (1/255)) ** (1/gamma)`` computed in f32 and stored as f32 or bf16.
It launches its CUDA kernel for CUDA tensors and adds one to its
``launches`` count; for CPU tensors it returns :func:`gamma_normalize_plain`,
which repeats the kernel's arithmetic (the f32 product by f32(1/255),
then ``pow`` by f32(1/gamma), then the cast). Any other device raises;
there is no fallback from a failed build or launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blendjax_torch.kernels.build import entry, load
from blendjax_torch.kernels.counting import count_launch
from blendjax_torch.kernels.work import gamma_work
from blendjax_torch.kernels.decode import _aligned16, _raise_on, _stream

OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gamma_normalize_plain(x, gamma: float = 2.2, dtype=torch.float32):
    """Plain K3: the same function in plain torch."""
    _check(x, dtype)
    return torch.pow(x.to(torch.float32) * (1.0 / 255.0), 1.0 / gamma).to(dtype)


def _check(x, dtype) -> str:
    if x.dtype != torch.uint8:
        raise TypeError(f"gamma_normalize takes uint8, got {x.dtype}")
    if dtype not in OUT_DTYPES:
        raise TypeError(f"output dtype must be float32 or bfloat16, got {dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no gamma-normalize kernel for device {x.device}")
    return x.device.type


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gamma_normalize(x, gamma: float = 2.2, dtype=torch.float32):
    """K3: ``x`` uint8 of any shape -> the same shape in ``dtype``."""
    if _check(x, dtype) == "cpu":
        return gamma_normalize_plain(x, gamma, dtype)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous for the CUDA kernel")
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    lib = load("gamma_normalize")
    fn = entry(lib, "bjt_gamma_normalize",
               [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p])
    words = x.data_ptr() % 4 == 0 and _aligned16(out)
    code = fn(
        x.data_ptr(), out.data_ptr(), x.numel(), OUT_DTYPES[dtype],
        int(words), 1.0 / 255.0, 1.0 / gamma,
        _sm_count(x.device.index or 0), _stream(x.device),
    )
    _raise_on(lib, "bjt_gamma_normalize_error", code, "gamma_normalize")
    count_launch(gamma_normalize, work=lambda: gamma_normalize.work(x, dtype))
    return out


gamma_normalize.launches = 0
gamma_normalize.work = lambda x, dtype=torch.float32: gamma_work(
    x.numel(), dtype.itemsize)
