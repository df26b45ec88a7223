"""Hand-written CUDA kernels of the port and their dispatch rule.

Each kernel has a wrapper in `ops.py`, a plain PyTorch version in
`ref.py` and a CUDA source under `repro_torch/csrc/`, compiled by
`build.py` at first use. The model calls the AltUp, decode-attention and
WKV wrappers; `ops.mha_flash` and `ops.mha_flash_paged` (flash attention
over contiguous or paged k/v, optionally int8/fp8 codes made by
`quant.quantize`) are entry points of their own, as in the reference,
where no model path reaches them.
"""
from __future__ import annotations

from typing import Optional

import torch


def resolve_kernel_flag(flag: Optional[bool], device: torch.device) -> bool:
    """Dispatch rule for the tri-state kernel levers on ModelConfig
    (ragged_decode_attn, fused_decode_altup). Returns whether the model
    calls the kernel wrapper (`ops.*`) instead of its dense path:

      None  -> the wrapper on a CUDA device (it launches the kernel); on
               the CPU the dense path, as the reference's auto mode takes
               its dense path off the TPU.
      True  -> the wrapper everywhere: the kernel on CUDA, the kernel's
               plain version (`ref.py`) on the CPU.
      False -> the dense path everywhere.

    There is no toolchain fallback: on a CUDA tensor a wrapper launches its
    kernel or raises.
    """
    if flag is None:
        return torch.device(device).type == "cuda"
    return bool(flag)
