"""Where the port's entry points run: on the card unless the caller asks
for another device."""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point builds on. None means the CUDA card, and
    raises where there is none: nothing falls back to the CPU silently. A
    caller that wants the CPU (the tests do) says `device="cpu"`."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False): the port runs on the card by default; pass "
            'device="cpu" to build on the CPU')
    return torch.device("cuda")
