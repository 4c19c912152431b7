"""Streaming per-frame video path, PyTorch port of
``hygrid_tpu/models/video.py`` (720p/30 fps: per-frame rect->hex resample
and hex filtering).

The processors are plain callables (PyTorch runs eagerly: there is no jit
to build).  :func:`process_stream` keeps ``depth`` frames in flight on the
card: each frame is copied into one of a ring of pinned host buffers, sent
to the device on a side copy stream, and processed on the current stream
once its copy event has fired, so the copy of frame t+1 overlaps the work
on frame t.  A pinned buffer is refilled only after its previous copy has
completed.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Iterable, Iterator, Optional, Tuple

import torch

from ..nn import filters
from ..ops import geometry

__all__ = ["make_frame_processor", "make_batch_processor", "process_stream",
           "StreamStats"]


def _make_processor(batched, height, width, hex_size, interpolation,
                    filter_taps, post, compute_dtype, device):
    if hex_size is None:
        hex_size = (height // 2, width // 2)
    if filter_taps is None:
        filter_taps = filters.hex_gaussian_kernel(1.0)
    device = torch.device(device)
    taps = torch.as_tensor(filter_taps, dtype=compute_dtype, device=device)

    def process(frames):
        x = torch.as_tensor(frames).to(device).to(compute_dtype)
        hexed = geometry.rect_to_hex_resample(x if batched else x[None],
                                              hex_size, interpolation)
        out = filters.hex_filter(hexed, taps)
        if post is not None:
            out = post(out)
        return out if batched else out[0]

    process.device = device
    return process


def make_frame_processor(height: int, width: int,
                         hex_size: Optional[Tuple[int, int]] = None,
                         interpolation: str = "bilinear",
                         filter_taps=None,
                         post: Optional[Callable] = None,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         device="cuda"):
    """Build a (C, H, W) -> hex frame processor on ``device``.

    Default pipeline: rect->hex at half resolution + hex Gaussian blur.
    ``post`` can append any work on the hex frame (1, C, h, w), e.g. a
    port ``HexCNN``.  The frame (numpy array or tensor) is moved to
    ``device`` and cast to ``compute_dtype``: video frames are 8/10-bit
    content, so bf16 is lossless for the samples; the resample accumulates
    in float32 either way.  The result stays on the device.
    """
    return _make_processor(False, height, width, hex_size, interpolation,
                           filter_taps, post, compute_dtype, device)


class StreamStats:
    def __init__(self):
        self.frames = 0
        self.seconds = 0.0

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else float("inf")


def make_batch_processor(height: int, width: int,
                         hex_size: Optional[Tuple[int, int]] = None,
                         interpolation: str = "bilinear",
                         filter_taps=None,
                         post: Optional[Callable] = None,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         device="cuda"):
    """Batched variant of :func:`make_frame_processor`: (B, C, H, W) in,
    processed hex frames out.  Use with ``process_stream(microbatch=k)``
    to amortise per-launch overhead; same ``compute_dtype`` policy as the
    per-frame processor."""
    return _make_processor(True, height, width, hex_size, interpolation,
                           filter_taps, post, compute_dtype, device)


class _Staging:
    """Host-to-device copies through a ring of pinned host buffers on a
    side copy stream of ``device``."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)
        self.host = [None] * slots
        self.copied = [None] * slots
        self.next = 0

    def upload(self, frames, batched: bool) -> torch.Tensor:
        srcs = [torch.as_tensor(f) for f in frames]
        if srcs[0].device == self.device:
            return torch.stack(srcs) if batched else srcs[0]
        k = self.next
        self.next = (k + 1) % len(self.host)
        if self.copied[k] is not None:
            # the previous copy out of this buffer must have finished
            # reading it before the buffer is refilled
            self.copied[k].synchronize()
        shape = ((len(srcs),) if batched else ()) + tuple(srcs[0].shape)
        buf = self.host[k]
        if buf is None or tuple(buf.shape) != shape \
                or buf.dtype != srcs[0].dtype:
            buf = self.host[k] = torch.empty(shape, dtype=srcs[0].dtype,
                                             pin_memory=True)
        if batched:
            torch.stack(srcs, out=buf)
        else:
            buf.copy_(srcs[0])
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            x = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        compute.wait_event(event)
        x.record_stream(compute)
        self.copied[k] = event
        return x


def process_stream(frames: Iterable, processor,
                   stats: Optional[StreamStats] = None,
                   depth: int = 8, microbatch: int = 1) -> Iterator:
    """Run the processor over a frame iterable with ``depth`` frames (or
    microbatches) in flight, yielding the processed frames in order.

    ``microbatch > 1`` stacks that many frames per call of a batch
    processor.  On a CUDA processor the frames go through pinned staging
    buffers and a copy stream (module docstring), and each result is
    yielded after its work on the device has finished; on the CPU the
    same loop runs without streams.
    """
    stats = stats if stats is not None else StreamStats()
    device = torch.device(getattr(processor, "device", "cpu"))
    # two pinned buffers: one fills while the other's copy runs (a copy
    # waits for nothing on the compute stream, so it ends within ms)
    staging = _Staging(device, 2) if device.type == "cuda" else None
    batched = microbatch > 1
    t0 = time.perf_counter()
    pending: deque = deque()
    n = 0

    def submit(group):
        if staging is None:
            srcs = [torch.as_tensor(f) for f in group]
            x = torch.stack(srcs) if batched else srcs[0]
            pending.append((processor(x), None))
            return
        out = processor(staging.upload(group, batched))
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        pending.append((out, done))

    def drain_one():
        out, done = pending.popleft()
        if done is not None:
            done.synchronize()
        if batched:
            yield from out
        else:
            yield out

    group = []
    for frame in frames:
        group.append(frame)
        n += 1
        if len(group) == microbatch:
            submit(group)
            group = []
            if len(pending) > depth:
                yield from drain_one()
    if group:
        submit(group)
    while pending:
        yield from drain_one()
    stats.frames = n
    stats.seconds = time.perf_counter() - t0
