"""Device selection for the port's entry points (the card by default) and
the write barrier's event."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises if there is none; the CPU
    is used only when the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def record_writes(device: torch.device):
    """A CUDA event recorded on ``device``'s current stream after the
    caller's writes: the handle an index's ``finish_upsert`` waits on (a
    batch's own barrier, not a whole-device synchronise: it waits for
    everything queued on that stream up to the event, and for nothing
    queued after it). ``None`` on the CPU, where the writes are done when
    the call returns."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event
