"""Double-buffered device staging over a framed candidate-block stream.

``DeviceStager`` pulls block N+1 from the feed and starts its H2D copy
BEFORE handing block N to the caller for dispatch — so at every yield
the next block's candidate upload is already in flight behind the
current block's device work.

On a CUDA device the copies run on a dedicated side stream: the
consumer thread pins the block's column-trimmed rows and copies them
``non_blocking`` on that stream, then records an event on it after the
block's copies.  Before the block is handed out for dispatch, the
compute (current) stream waits on that event — so no kernel reads the
rows before they land — and the device tensor is marked with
``record_stream`` on the compute stream, so the caching allocator cannot
hand its memory to another tensor while the compute stream may still
read it.  On the CPU, where the caller asked for the CPU, a block's rows
are a plain host tensor.

The stager composes with the engine's ``_Pipeline`` (which trails the
hits-gate sync ``PIPELINE_DEPTH`` batches behind dispatch): the
pipeline hides the device->host gate latency, the stager hides the
host->device candidate upload, and the feed's producer threads hide
the packing.  Producer threads never touch the device; all staging
happens here, on the consumer thread.

Stream order is untouched: blocks are staged and yielded strictly in
feed order, and a block is staged exactly once.
"""

from collections import deque

import numpy as np
import torch

from ..parallel.device import resolve_device


class DeviceStager:
    """Yield ``(block, prep)`` with ``depth`` blocks' H2D staged ahead.

    ``depth=1`` is classic double buffering: one staged block in flight
    beyond the one being dispatched.  ``prep`` is the engine's prepared
    triple (or None for a block with no valid words — the caller skips
    it but still reports its ``count``).  ``device`` defaults to the
    engine's.  ``staged`` counts the blocks prepared (each exactly once).
    """

    def __init__(self, engine, blocks, depth: int = 1, device=None):
        self.engine = engine
        self.blocks = iter(blocks)
        self.depth = max(0, int(depth))
        self.device = resolve_device(engine.device if device is None else device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.staged = 0

    def h2d(self, rows: np.ndarray) -> torch.Tensor:
        """Start the copy of contiguous uint32 ``rows`` to the device on
        the side stream; returns the device tensor (int32, same bits).
        On the CPU the rows are returned as a host tensor."""
        host = torch.from_numpy(rows.view(np.int32))
        if self.stream is None:
            return host
        with torch.cuda.stream(self.stream):
            return host.pin_memory().to(self.device, non_blocking=True)

    def ready_now(self, prep):
        """Order the current stream after the copies the stager has
        started so far and return ``prep``, ready to dispatch: the
        one-block form of the iteration below, for a caller that pulls
        its own blocks (a device stream).  A ``prep`` that is not the
        engine's staged triple (a rules stream's dispatched records) is
        only ordered."""
        if self.stream is not None:
            self._ready(prep, self.stream.record_event())
        return prep

    def _ready(self, prep, done):
        """Order the compute stream after a block's copies (the event
        ``done``), and keep the rows' memory from reuse until the
        compute stream is done with them."""
        if done is None:
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        if isinstance(prep, tuple):
            rows = prep[2]  # a tensor, or a PMK-store MixedPrep
            staged = (rows.device_tensors() if hasattr(rows, "device_tensors")
                      else (rows,))
            for t in staged:
                t.record_stream(compute)

    def __iter__(self):
        staged = deque()  # (block, prep, event), oldest first
        exhausted = False
        while True:
            while not exhausted and len(staged) <= self.depth:
                blk = next(self.blocks, None)
                if blk is None:
                    exhausted = True
                    break
                # the H2D starts here, ahead of the caller's dispatch
                prep = self.engine._prepare_block(blk, stager=self)
                self.staged += 1
                done = None if self.stream is None else self.stream.record_event()
                staged.append((blk, prep, done))
            if not staged:
                return
            blk, prep, done = staged.popleft()
            self._ready(prep, done)
            yield blk, prep
