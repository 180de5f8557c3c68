"""Where the port's entry points run: on the card unless the caller asks
for another device."""
import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point builds on. None means the CUDA card (in
    a process group, the rank's own: cuda:LOCAL_RANK, torchrun's
    numbering), and raises where there is none: nothing falls back to the
    CPU silently. A caller that wants the CPU (the tests do) says
    `device="cpu"`.

    On the card the port computes fp32 in fp32: torch leaves matmuls so,
    but runs cuDNN's fp32 convolutions (the SmallStem's) as TF32 unless
    told otherwise, so this turns that off."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available (torch.cuda.is_available() is "
                "False): the port runs on the card by default; pass "
                'device="cpu" to build on the CPU')
        device = "cuda"
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
    return device
